"""Profile-matrix performance harness — the port's twin of
``lora_phy_tpu/runners/perf_test.py``.

Equivalent of the reference's ``tests/performance_test.cpp``: a
1000-packet modulate -> dechirp -> demodulate loop per profile on
``--device=``, writing ``logs/performance_<RUN_ID>.csv`` with the same
schema (the rdtsc cycles-per-symbol column becomes wall-clock
``us_per_symbol``). ``RUN_ID`` comes from the environment like the
reference (performance_test.cpp:67-69); gate regressions with
``runners/compare_perf.py``.
"""

from __future__ import annotations

import os
import pathlib
import sys
import time

import numpy as np
import torch

from .. import device_of
from ..models import modem
from ..ops import planar
from ..utils.params import LoraParams
from ..utils.profiles import DEFAULT_PROFILES, load_profiles
from ._cli import DEVICE_FLAG, device_from, parse_flags


def synchronize(dev: torch.device) -> None:
    """Wait for the work queued on ``dev`` (CPU ops run to completion)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_profile(params: LoraParams, packets: int, payload_len: int = 32,
                device=None):
    """Batched equivalent of the reference's packet loop: all packets ride
    one device batch; returns (pps, us_per_symbol)."""
    dev = device_of(None, device)
    # bound the batch as the JAX twin does (~280 M samples: the raw TX,
    # the dechirped planes and the demod workspace at SF12)
    frame_samples = (payload_len * 2 + 2) * params.step
    cap = max(64, int(2.8e8 // frame_samples))
    if packets > cap:
        print(f"  [capping {packets} -> {cap} packets for N={params.n}]",
              file=sys.stderr)
        packets = cap
    rng = np.random.RandomState(0)
    payloads = rng.randint(0, 256, (packets, payload_len)).astype(np.uint8)
    pl = torch.from_numpy(payloads).to(dev)
    xr, xi = planar.dechirp_planar(
        *planar.modulate_planar(modem.encode(pl), params), params)

    def step():
        return planar.demodulate_planar(xr, xi, params).symbols

    step()
    synchronize(dev)
    # sanity: demodulated bins must match the reference-faithful
    # expectation (bins scale by bw_scale at BW250/500 — docs/SEMANTICS.md)
    first = step()[:4].cpu().numpy()
    enc = modem.encode(pl[:4]).cpu().numpy()
    scale = int(round(params.scale))
    expect = (enc.astype(np.int64) * scale) % params.n
    if not np.array_equal(first.astype(np.int64), expect):
        raise RuntimeError("perf harness demod mismatch")
    if scale == 1:
        decoded = modem.decode(torch.from_numpy(first).to(dev)).cpu().numpy()
        if not np.array_equal(decoded, payloads[:4]):
            raise RuntimeError("perf harness decode mismatch")
    # one completion barrier per timed batch of 24 calls, best of 2 (the
    # JAX twin's timing shape)
    iters = 24
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        synchronize(dev)
        best = min(best, (time.perf_counter() - t0) / iters)
    dt = best

    n_sym = payload_len * 2 + 2
    pps = packets / dt
    us_per_symbol = dt * 1e6 / (packets * n_sym)
    return pps, us_per_symbol


def main(argv=None) -> int:
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "profiles": (str, ""),
        "packets": (int, 1000),
        "payload-bytes": (int, 32),
        "out-dir": (str, "logs"),
        "device": DEVICE_FLAG,
    })
    dev = device_from(flags)
    if dev is None:
        return 1
    profiles = (
        load_profiles(flags["profiles"]) if flags["profiles"] else DEFAULT_PROFILES
    )
    run_id = os.environ.get("RUN_ID", "run")
    out_dir = pathlib.Path(flags["out-dir"])
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"performance_{run_id}.csv"

    rows = ["run_id,profile,sf,N,pps,us_per_symbol"]
    for p in profiles:
        params = p.params()
        pps, usps = run_profile(params, flags["packets"], flags["payload-bytes"],
                                device=dev)
        rows.append(
            f"{run_id},{p.name},{p.sf},{1 << p.sf},{pps:.3f},{usps:.3f}"
        )
        print(rows[-1], file=sys.stderr)
    out.write_text("\n".join(rows) + "\n")
    print(f"wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
