#!/usr/bin/env python3
"""Per-stage profile of the port's block receiver at the bench shape — the
twin of ``tools/profile_block_rx.py``.

The workload is the block receiver stage of the port's bench
(``lora_phy_tpu_torch/runners/bench.py``, built by its own builders from
its payload draw): 8 channels x 512 frames of one 16-byte SF7 payload
each, four zero windows after every frame (~25.3 M samples per plane),
through ``receive_block_planar`` on its circular path
(``lora_phy_tpu_torch/models/sync.py::_receive_block_circular``). Where the
JAX tool times cumulative jitted prefixes (XLA fuses across stages), the
port runs eagerly, so each stage is a ``record_function`` range in the
receiver itself (``sync.CIRCULAR_STAGES``: front, gather, probes,
sections, dechirp, estimator, demod, sro), entered only while a profiler
runs (``utils/profiling.stage_range``). One profiler window of five calls
attributes every device event to the range that launched it; per call and
stage it prints the device ms, the host ms and the launches, then the
call's wall, device busy time and idle share, and the receiver's time per
call without the profiler (best of two batches of 24 calls, one
synchronize per batch, as the JAX tool's loop) and what the stage markers
cost a call in host time when no profiler runs.

Usage: python tools/torch_profile_block_rx.py [--frames=512] [--device=cuda:0]
(``--device=cpu`` caps the frames at 8, as the JAX tool on a CPU backend;
the device columns are then 0.)
"""

from __future__ import annotations

import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from lora_phy_tpu_torch import LoraParams  # noqa: E402
from lora_phy_tpu_torch.models import sync  # noqa: E402
from lora_phy_tpu_torch.runners import bench  # noqa: E402
from lora_phy_tpu_torch.runners._cli import DEVICE_FLAG, device_from, parse_flags  # noqa: E402
from lora_phy_tpu_torch.utils.profiling import range_profile, stage_range  # noqa: E402

# calls in the profiler window
CALLS = 5


def block_rx_call(dev: torch.device, frames: int):
    """(the bench's block receiver call, the stream's samples per plane)
    with ``frames`` frames per channel."""
    p = LoraParams(sf=7)
    pay_blk = bench.payload_draws(bench.shapes(dev))[1]
    br, bi = bench.framed_stream(pay_blk, frames, p, dev)
    return bench.block_rx_call(br, bi, p, frames), br.numel()


def range_cost_us(count: int = 20000) -> float:
    """Host microseconds of one stage marker (``stage_range``) entered and
    left with no profiler running: what each of the receiver's stages
    costs a call for its marker."""
    t0 = time.perf_counter()
    for _ in range(count):
        with stage_range("range_cost"):
            pass
    return (time.perf_counter() - t0) / count * 1e6


def main(argv=None) -> int:
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "frames": (int, 512),
        "device": DEVICE_FLAG,
    })
    dev = device_from(flags)
    if dev is None:
        return 1
    frames = min(flags["frames"], 8) if dev.type == "cpu" else flags["frames"]
    call, total = block_rx_call(dev, frames)
    card = bench.card_name(dev) if dev.type == "cuda" else "cpu"
    print(f"workload: {total / 1e6:.1f}M samples, {bench.shapes(dev).channels}x{frames} "
          f"frames; {card}",
          file=sys.stderr)
    prof = range_profile(call, sync.CIRCULAR_STAGES, calls=CALLS)
    for line in prof.lines("block receiver"):
        print(line, flush=True)
    iters = 24 if dev.type == "cuda" else 1
    dt, _ = bench._timeit(call, lambda: bench.synchronize(dev), iters)
    print(f"block receiver: full-receiver {dt * 1e3:.3f} ms per call without the profiler "
          f"(best of 2 x {iters})", flush=True)
    us = range_cost_us()
    n = len(sync.CIRCULAR_STAGES)
    print(f"block receiver: a stage marker costs {us:.2f} us of host time without the "
          f"profiler; the call's {n} markers {n * us / 1e3:.4f} ms "
          f"({n * us / 1e3 / (dt * 1e3):.5f} of the call)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
