"""Tracing / roofline accounting — the port's twin of
``lora_phy_tpu/utils/profiling.py``.

The reference's observability is rdtsc cycle counting around the packet
loop (reference: tests/performance_test.cpp:103-133). Here:

* :func:`trace` — context manager around ``torch.profiler`` that writes a
  Chrome trace JSON (``trace.json``) into a log directory;
* :func:`stage_range` — a stage's ``record_function`` range while a
  profiler runs, nothing otherwise; :func:`host_sync` — the same around
  each point where a hot path makes the host wait for the device, counted
  in :data:`HOST_SYNCS`; :func:`launch_range` — an operator-level range
  around a hand kernel's ``ctypes`` launch, so that the profiler links
  the kernel to the stage that launched it;
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

import collections
import contextlib
import dataclasses
import os
import pathlib
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from .params import LoraParams

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W power limit):
# float32 outside the tensor cores, dense bf16 on the tensor cores, and
# HBM3 bandwidth
H100_F32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12
H100_HBM_BPS = 3.35e12

# host syncs passed (:func:`host_sync`), on every device: on a CUDA device
# each is a point where the host waits for the queue to drain
HOST_SYNCS = 0


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike | None = None):
    """Profile the body with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is visible) and write its Chrome trace to
    ``log_dir/trace.json`` (default: ``lora_phy_torch_trace`` under the
    temporary directory). Yields the directory."""
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


def stage_range(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler runs, else a no-op: code marks its stages with it and pays
    for the ranges only when traced."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()


def launch_range(name: str):
    """While a profiler runs, an operator-level range named ``name``
    around a launch made outside PyTorch's operators (a hand kernel called
    through ``ctypes``), else a no-op. The profiler links a device event
    to the innermost operator open at its launch, never to a
    ``record_function`` range (a user annotation): without this range a
    hand kernel is linked to nothing, and no stage range holds it."""
    if torch._C._autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return contextlib.nullcontext()


def host_sync():
    """Mark the one expression of a hot path that makes the host wait for
    the device (a device-to-host read, a pageable host-to-device copy):
    adds 1 to :data:`HOST_SYNCS` and returns ``stage_range("host_sync")``,
    so that while a profiler runs the range's host time is the wait."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return stage_range("host_sync")


@dataclasses.dataclass
class RangeProfile:
    """Per call of a profiled function: for each ``record_function``
    range, (device ms of the kernels launched inside it, host ms, device
    events); the same for device events launched outside every range
    (``other``); the device ms of each kernel name; the host wall ms, the
    device busy ms (the union of the device events' intervals) and the
    device events per call."""

    stages: dict
    other: tuple
    kernels: dict
    wall_ms: float
    busy_ms: float
    events: float

    def lines(self, label: str) -> list[str]:
        out = [f"{label}: {'stage':>10} {'device ms':>10} {'host ms':>9} {'launches':>9}"]
        for name, (dev_ms, host_ms, n) in [*self.stages.items(), ("(outside)", self.other)]:
            host = "" if host_ms is None else f"{host_ms:9.3f}"
            out.append(f"{label}: {name:>10} {dev_ms:10.3f} {host:>9} {n:9.1f}")
        out.append(f"{label}: per call: wall {self.wall_ms:.3f} ms, device busy "
                   f"{self.busy_ms:.3f} ms, idle share {self.idle_share:.3f}, "
                   f"{self.events:.0f} device events; the stages' device ms add up to "
                   f"{sum(v[0] for v in self.stages.values()):.3f}")
        return out

    @property
    def idle_share(self) -> float:
        """One minus busy over wall; the wall includes the profiler's own
        host cost, so this is an upper bound."""
        return 1.0 - self.busy_ms / self.wall_ms if self.wall_ms > 0 else float("nan")


def _is_device_event(e, names) -> bool:
    """A device activity (kernel, copy, set) rather than the device-side
    span of a ``record_function`` range."""
    return (e.device_type == DeviceType.CUDA and e.name not in names
            and not getattr(e, "is_user_annotation", False)
            and "annotation" not in str(getattr(e, "activity_type", "") or ""))


def range_profile(fn, names, calls: int = 5) -> RangeProfile:
    """One ``torch.profiler`` window of ``calls`` back-to-back calls of
    ``fn()`` after a warm-up. Each range in ``names`` gets the device
    events that the profiler links to the ops inside it (their durations
    and count) and its own host time. The wall time includes the
    profiler's own host cost, so the idle share is an upper bound. On the
    CPU the device columns are 0."""
    cuda = torch.cuda.is_available()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    fn()
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    events = list(prof.events())
    device = [e for e in events if _is_device_event(e, names)]
    # each device event is counted once, in the range that launched it
    unclaimed = collections.Counter((e.name, e.time_range.elapsed_us()) for e in device)

    def subtree(e):
        """(device us, device events) linked to ``e`` and the ops under it."""
        us, count = 0.0, 0
        for k in e.kernels:
            if unclaimed[(k.name, k.duration)] > 0:
                unclaimed[(k.name, k.duration)] -= 1
                us, count = us + k.duration, count + 1
        for ch in e.cpu_children:
            c_us, c_n = subtree(ch)
            us, count = us + c_us, count + c_n
        return us, count

    acc = {name: [0.0, 0.0, 0] for name in names}
    for r in events:
        if r.device_type == DeviceType.CPU and r.name in acc:
            us, count = subtree(r)
            acc[r.name][0] += us
            acc[r.name][1] += r.time_range.elapsed_us()
            acc[r.name][2] += count
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, end = 0.0, spans[0][0] if spans else 0.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    kernels = collections.Counter()
    for e in device:
        kernels[e.name] += e.time_range.elapsed_us() / 1e3 / calls
    other_us = sum(e.time_range.elapsed_us() for e in device) - sum(v[0] for v in acc.values())
    other_n = len(device) - sum(v[2] for v in acc.values())
    return RangeProfile(
        {name: (v[0] / 1e3 / calls, v[1] / 1e3 / calls, v[2] / calls) for name, v in acc.items()},
        (other_us / 1e3 / calls, None, other_n / calls), dict(kernels), wall_ms,
        busy / 1e3 / calls, len(spans) / calls)


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
