"""Roofline evidence harness — the port's twin of
``lora_phy_tpu/runners/roofline.py``.

Measures on ``--device=`` (default the first CUDA card): the fixed
dispatch overhead of one small op, the effective memory bandwidth (an
elementwise stream at two sizes, differenced to cancel the overhead), and
the demod step time against its floors at SF7 and SF12: the compute floor
of :func:`..utils.profiling.demod_roofline` at the H100's published f32
peak, and the intrinsic-traffic floor (the planar input once) at the
measured bandwidth. The reference has no such harness; its observability
is rdtsc cycle counting (tests/performance_test.cpp:103-133).

  python -m lora_phy_tpu_torch.runners.roofline [--channels=8] [--frames=8192] [--device=cuda:0]
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from .. import device_of
from ..models import modem
from ..ops import planar
from ..utils.params import LoraParams
from ..utils.profiling import H100_F32_FLOPS, H100_HBM_BPS, demod_roofline
from ._cli import DEVICE_FLAG, device_from, parse_flags
from .perf_test import synchronize


def _timeit(fn, sync, iters):
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters


def measure_dispatch_overhead(dev: torch.device) -> float:
    """Seconds per call of one small op (two floats plus one), queued
    back to back and waited for once."""
    tiny = torch.zeros(2, dtype=torch.float32, device=dev)
    return _timeit(lambda: tiny + 1.0, lambda: synchronize(dev), 16)


def measure_bandwidth(dev: torch.device, sizes=(2**27, 2**29)) -> float:
    """Effective memory r+w bandwidth in bytes/s: one read and one write
    per float32 element (``torch.mul`` into a preallocated output), timed
    at two sizes whose difference cancels the fixed overhead; the median
    of three paired measurements (512 MiB / 2 GiB by default)."""
    arrays = [torch.zeros(n, dtype=torch.float32, device=dev) for n in sizes]
    outs = [torch.empty_like(a) for a in arrays]

    def one_round():
        ts = [_timeit(lambda a=a, o=o: torch.mul(a, 1.0000001, out=o),
                      lambda: synchronize(dev), 8)
              for a, o in zip(arrays, outs)]
        return ts[1] - ts[0]

    dt = float(np.median([one_round() for _ in range(3)]))
    return 2 * (sizes[1] - sizes[0]) * 4 / dt


def measure_demod(params: LoraParams, n_frames: int, channels: int,
                  payload_len: int = 32, device=None):
    """(seconds per ``demodulate_planar`` call, IQ samples per call) over
    ``channels`` x ``n_frames`` frames of a tiled 64-payload pool."""
    dev = device_of(None, device)
    pool = min(64, n_frames * channels)
    rng = np.random.RandomState(0)
    payloads = torch.from_numpy(
        rng.randint(0, 256, (pool, payload_len)).astype(np.uint8)).to(dev)
    reps = -(-(channels * n_frames) // pool)       # ceil: any frame count
    full = payloads.repeat(reps, 1)[: channels * n_frames].reshape(
        channels, n_frames, payload_len)
    xr, xi = planar.dechirp_planar(
        *planar.modulate_planar(modem.encode(full), params), params)
    dt = _timeit(lambda: planar.demodulate_planar(xr, xi, params).symbols,
                 lambda: synchronize(dev), 6)
    total = channels * n_frames * (payload_len * 2 + 2) * params.step
    return dt, total


def card_name(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    torch's device name where ``nvidia-smi`` is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        out = None
    lines = out.stdout.strip().splitlines() if out is not None and out.returncode == 0 else []
    if len(lines) > (dev.index or 0):
        return lines[dev.index or 0]
    return f"{torch.cuda.get_device_name(dev)} (power limit not read: no nvidia-smi)"


def main(argv=None) -> int:
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "channels": (int, 8),
        "frames": (int, 8192),
        "device": DEVICE_FLAG,
    })
    dev = device_from(flags)
    if dev is None:
        return 1
    peaks = (f"H100 SXM published peaks: {H100_F32_FLOPS / 1e12:g} TFLOP/s f32, "
             f"{H100_HBM_BPS / 1e12:g} TB/s HBM")
    if dev.type == "cuda":
        print(f"device: {dev}: {card_name(dev)}; {peaks}", file=sys.stderr)
    else:
        print(f"device: {dev}; {peaks}: the floors below are the H100's, not "
              f"this device's", file=sys.stderr)

    overhead = measure_dispatch_overhead(dev)
    bw = measure_bandwidth(dev)
    print(f"dispatch overhead: {overhead*1e3:.3f} ms")
    print(f"effective bandwidth (r+w, overhead-cancelled): {bw/1e9:.0f} GB/s "
          f"({bw / H100_HBM_BPS:.3f} of the H100's {H100_HBM_BPS/1e9:.0f} GB/s)")

    # SF12 frames are 32x larger; keep the batch inside device memory
    for sf, channels, frames in (
        (7, flags["channels"], flags["frames"]),
        (12, 1, max(64, flags["frames"] // 8)),
    ):
        p = LoraParams(sf=sf)
        dt, total = measure_demod(p, frames, channels, device=dev)
        in_bytes = total * 8.0                      # planar f32 planes
        t_mem_intrinsic = in_bytes / bw
        implied_traffic = dt * bw
        r = demod_roofline(p, total // p.n, peak_flops=H100_F32_FLOPS,
                           peak_bw=bw)
        print(
            f"SF{sf}: measured {dt*1e3:.3f} ms ({total/dt/1e9:.2f} Gsps) | "
            f"compute floor {r.t_compute_s*1e3:.3f} ms | "
            f"intrinsic-traffic floor {t_mem_intrinsic*1e3:.3f} ms | "
            f"implied real traffic {implied_traffic/2**30:.0f} GiB "
            f"(~{implied_traffic/in_bytes:.0f} passes)"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
