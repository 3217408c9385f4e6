"""Scaling-efficiency harness for the sharded streaming demodulator — the
twin of ``lora_phy_tpu/runners/bench_scaling.py``.

Runs the planar time/channel-sharded streaming demod
(parallel/stream.py) over growing device counts and reports, per count:

* wall time + aggregate samples/s for the FULL sharded program,
* the same program with every cross-shard collective stubbed
  (``demodulate_stream_planar(..., comm=False)``) — the paired difference
  is the measured **collective cost** of the mesh program,
* efficiency vs the first row (strong: fixed global work; weak: fixed
  per-device work).

    python -m lora_phy_tpu_torch.runners.bench_scaling --mode=weak \\
        --devices=1,2,4,8 [--sf=7] [--frames=32] [--out=PATH] [--device=cpu]

Device counts are capped by the visible devices: the CUDA cards by
default (``--devices=1`` on one card), or with ``--device=cpu`` eight
CPU shards that share the host's cores (the JAX suite's eight virtual CPU
devices) — wall-clock efficiency there is bounded by the cores and is
not a hardware claim; the collective fraction is the mesh program's own.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np
import torch

from .. import LoraParams
from ..models import modem
from ..ops import planar
from ..parallel import mesh as meshlib
from ..parallel.stream import demodulate_stream_planar
from ._cli import DEVICE_FLAG, device_from, parse_flags

# CPU shards of --device=cpu: the JAX suite's virtual device count
CPU_SHARDS = 8


def _barrier(out):
    """Completion barrier: one small host read of the symbols."""
    out[0][0, :2].cpu()


def _time_pair(fn_a, fn_b, iters: int, repeats: int = 7):
    """Per-call times for two program variants over ``repeats`` batches,
    INTERLEAVED (a, b, a, b, ...) so host drift hits both alike. Returns
    ``(fulls, stubs, diffs)``; ``diffs`` pairs each full batch with the
    stubbed batch measured next to it (a paired difference, summarised as
    a median with a spread)."""
    for fn in (fn_a, fn_b):
        _barrier(fn())
    fulls, stubs, diffs = [], [], []
    for _ in range(repeats):
        ts = []
        for fn in (fn_a, fn_b):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn()
            _barrier(out)
            ts.append((time.perf_counter() - t0) / iters)
        fulls.append(ts[0])
        stubs.append(ts[1])
        diffs.append(ts[0] - ts[1])
    return fulls, stubs, diffs


def measure(devices: list, params: LoraParams, payload_len: int,
            frames_per_device: int, mode: str, channels: int,
            iters: int = 4, repeats: int = 7) -> dict:
    """One mesh point over ``devices``: build a (channel x time) mesh, run
    the planar sharded streaming demod with and without collectives, and
    verify the full run's decoded payloads bit-exactly."""
    n_devices = len(devices)
    n_time = 2 if n_devices % 2 == 0 else 1
    n_channel = n_devices // n_time
    m = meshlib.make_mesh(n_channel=n_channel, n_time=n_time, devices=devices)

    if mode == "weak":
        channels = n_channel
        frames_per_channel = frames_per_device * n_time
    else:                               # strong: fixed global work
        frames_per_channel = frames_per_device

    rng = np.random.RandomState(0)
    payloads = torch.from_numpy(rng.randint(
        0, 256, (channels * frames_per_channel, payload_len)).astype(np.uint8))
    home = m.home
    syms = modem.encode(payloads.to(home))
    re, im = planar.modulate_planar(syms, params)
    dr, di = planar.dechirp_planar(re, im, params)
    del re, im
    sh = meshlib.stream_sharding(m)
    xr = meshlib.device_put(dr.reshape(channels, -1), sh)
    xi = meshlib.device_put(di.reshape(channels, -1), sh)

    fulls, stubs, diffs = _time_pair(
        lambda: demodulate_stream_planar(xr, xi, params, m),
        lambda: demodulate_stream_planar(xr, xi, params, m, comm=False),
        iters, repeats=repeats)
    t_full = float(np.median(fulls))
    t_nocomm = float(np.median(stubs))
    d_med = float(np.median(diffs))
    # robust sigma of the paired differences (IQR/1.349)
    q1, q3 = np.percentile(diffs, [25, 75])
    d_spread = float(q3 - q1) / 1.349

    # correctness of the timed program (full path only; comm=False is a
    # measurement stub, wrong at seams by design)
    out_syms, _, _, _ = demodulate_stream_planar(xr, xi, params, m)
    # each frame is 2 sync symbols + the encoded payload symbols
    got = out_syms.reshape(-1, syms.shape[-1] + 2)
    if not torch.equal(modem.decode(got[:, 2:]).cpu(), payloads):
        raise AssertionError("sharded demod decode mismatch")

    total = dr.numel()
    return {
        "devices": n_devices,
        "mesh": f"{n_channel}x{n_time}",
        "mode": mode,
        "global_samples": int(total),
        "samples_per_device": int(total // n_devices),
        "t_full_ms": round(t_full * 1e3, 3),
        "t_nocomm_ms": round(t_nocomm * 1e3, 3),
        # median paired difference +- robust sigma, unclamped: a value
        # within its own spread means the collectives are below the
        # measurement noise at this point (below_noise flags it)
        "collective_ms": round(d_med * 1e3, 3),
        "collective_ms_spread": round(d_spread * 1e3, 3),
        "collective_frac": round(d_med / t_full, 4),
        "collective_frac_spread": round(d_spread / t_full, 4),
        "below_noise": bool(abs(d_med) <= d_spread),
        "repeats": repeats,
        "samples_per_s": total / t_full,
    }


def main(argv=None) -> int:
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "devices": (str, "1,2,4,8"),
        "sf": (int, 7),
        "payload-bytes": (int, 32),
        "frames": (int, 32),
        "mode": (str, "weak"),
        "iters": (int, 4),
        "repeats": (int, 7),
        "out": (str, "-"),
        "device": DEVICE_FLAG,
    })
    if flags["mode"] not in ("weak", "strong"):
        print("--mode must be weak or strong", file=sys.stderr)
        return 1
    dev = device_from(flags)
    if dev is None:
        return 1
    if dev.type == "cuda":
        visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        visible = [dev] * CPU_SHARDS
    params = LoraParams(sf=flags["sf"])
    counts = [int(x) for x in flags["devices"].split(",") if x]
    counts = [c for c in counts if c <= len(visible)]
    # strong mode shards ONE fixed global array over every mesh: channels
    # must divide by every n_channel (= N odd, N/2 even)
    if flags["mode"] == "strong":
        n_chans = [c // 2 if c % 2 == 0 else c for c in counts]
        channels = math.lcm(*n_chans) if n_chans else 1
    else:
        channels = 0

    rows = []
    base = None
    for c in counts:
        row = measure(visible[:c], params, flags["payload-bytes"], flags["frames"],
                      flags["mode"], channels, flags["iters"], flags["repeats"])
        if base is None:
            base = row
        if flags["mode"] == "weak":
            # constant per-device work: ideal is flat per-device time
            row["efficiency"] = round(base["t_full_ms"] / row["t_full_ms"], 4)
        else:
            # anchor the first measured row at 1.0 (like weak mode)
            row["efficiency"] = round(
                (row["samples_per_s"] / base["samples_per_s"])
                / (c / base["devices"]), 4)
        rows.append(row)
        print(
            f"devices={c} mesh={row['mesh']}: {row['t_full_ms']:.1f} ms "
            f"({row['samples_per_s']/1e6:.1f} Msamples/s aggregate), "
            f"collectives {row['collective_ms']:.2f}"
            f"±{row['collective_ms_spread']:.2f} ms "
            f"({row['collective_frac']*100:.1f}"
            f"±{row['collective_frac_spread']*100:.1f}%"
            f"{', below noise' if row['below_noise'] else ''}), "
            f"efficiency={row['efficiency']*100:.0f}%",
            file=sys.stderr,
        )

    platform = "gpu" if dev.type == "cuda" else "cpu"
    doc = {
        "mode": flags["mode"],
        "platform": platform,
        "device": torch.cuda.get_device_name(dev) if platform == "gpu" else "cpu",
        "host_cores": os.cpu_count(),
        "virtual_mesh": platform == "cpu",
        "interpretation": (
            "collective_frac is the mesh program's own communication cost "
            "(median paired full-minus-stubbed difference ± robust sigma "
            "over repeats); a value within its spread (below_noise) means "
            "collectives are unmeasurable at that point — expected at "
            "devices=1, whose only collectives are local copies. "
            "collective_frac need not be monotone in device count: the "
            "halo/broadcast pattern depends on the time-axis length. "
            + ("Wall-clock efficiency over CPU shards is bounded by "
               "host_cores shared across all shards and is NOT a hardware "
               "claim" if platform == "cpu" else
               "hardware run: efficiency is the scaling claim")),
        "rows": rows,
    }
    text = json.dumps(doc, indent=1)
    if flags["out"] in ("", "-"):
        print(text)
    else:
        with open(flags["out"], "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
