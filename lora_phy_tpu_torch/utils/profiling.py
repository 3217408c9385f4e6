"""Tracing / roofline accounting — the port's twin of
``lora_phy_tpu/utils/profiling.py``.

The reference's observability is rdtsc cycle counting around the packet
loop (reference: tests/performance_test.cpp:103-133). Here:

* :func:`trace` — context manager around ``torch.profiler`` that writes a
  Chrome trace JSON (``trace.json``) into a log directory;
* :func:`demod_roofline` — analytic FLOP/byte accounting for the
  dechirp-detection pipeline, reporting the compute- and bandwidth-bound
  time floors and the attained fraction for a measured runtime, against
  the H100's published peaks.

:func:`demod_roofline` keeps the JAX twin's count (the planar DFT as real
matmuls). It is not the kernel bound that ``chip_smoke.py`` reports for
the CUDA kernel (phase 4: ``5 N log2 N`` FFT flops + ``14 N`` per row, the
twiddle table among the bytes); the two count different algorithms and
are kept apart.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pathlib
import tempfile

from .params import LoraParams

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W power limit):
# float32 outside the tensor cores, dense bf16 on the tensor cores, and
# HBM3 bandwidth
H100_F32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12
H100_HBM_BPS = 3.35e12


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike | None = None):
    """Profile the body with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is visible) and write its Chrome trace to
    ``log_dir/trace.json`` (default: ``lora_phy_torch_trace`` under the
    temporary directory). Yields the directory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = pathlib.Path(log_dir or pathlib.Path(tempfile.gettempdir())
                           / "lora_phy_torch_trace")
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes: float
    t_compute_s: float
    t_memory_s: float
    bound: str

    def attained(self, measured_s: float) -> float:
        """Fraction of the speed-of-light floor achieved."""
        return max(self.t_compute_s, self.t_memory_s) / measured_s


def demod_roofline(params: LoraParams, n_symbols: int,
                   peak_flops: float = H100_F32_FLOPS,
                   peak_bw: float = H100_HBM_BPS) -> Roofline:
    """Speed-of-light floors for demodulating ``n_symbols`` symbol windows.

    Counts the JAX twin's intrinsic work: planar DFT as real matmuls
    (8*N per output point after splitting into <=128-wide stages), the
    derotation transcendentals, and the unavoidable HBM traffic (planar
    input in, one int per symbol out).
    """
    n = params.n
    if n <= 128:
        mm_flops = 8.0 * n * n          # 4 matmuls, 2 flops/MAC
    else:
        from ..ops.fft import _split

        n1, n2 = _split(n)              # the four-step factorisation
        mm_flops = 8.0 * n * (n1 + n2)
    flops = n_symbols * (mm_flops + 10.0 * n)     # + derot/mag/argmax
    bytes_ = n_symbols * (n * 8.0 + 4.0)          # planar in + bin out
    t_c = flops / peak_flops
    t_m = bytes_ / peak_bw
    return Roofline(flops, bytes_, t_c, t_m,
                    "compute" if t_c > t_m else "memory")
