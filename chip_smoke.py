#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (lora_phy_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout (the kernel is built
from ``lora_phy_tpu_torch/csrc`` into ``build/lora_phy_tpu_torch/``).
Imports no JAX. Phases, one line each (or a few):

0. the card: ``nvidia-smi`` name and power limit, and torch's device name;
1. build and load the CUDA kernel (seconds);
2. the kernel against its plain PyTorch twin on the card: SF5-7, with and
   without the Hann window, at random nonzero start/rate — clean chirp
   rows bit-equal, noise rows differing only at float32 near-ties — and
   the equal-power tie row (bin 0);
3. the main path at bench.py's headline size: 8 channels x 8192 frames of
   32-byte SF7 BW125 payloads (66 symbols x 128 samples per frame, 554 M IQ
   samples), encode -> modulate_planar -> dechirp_planar ->
   demodulate_planar(fused=True) -> decode on the card; every payload
   decoded bit-exact, sync 0x12, the kernel launched; per-stage times
   (CUDA events, median after a warm-up);
4. the same demod with fused=False (the plain torch path): the same
   symbols; both times, and the kernel against its twin on the main
   path's own rows.

Then a JSON line of the kernels and, last, ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero before the last line.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from lora_phy_tpu_torch import LoraParams, Window, _build
from lora_phy_tpu_torch.models import modem
from lora_phy_tpu_torch.ops import fused_demod as fused
from lora_phy_tpu_torch.ops import planar

CHANNELS, FRAMES, PAYLOAD_LEN, POOL = 8, 8192, 32, 64
NEAR_TIE_REL = 1e-5


def check(ok, msg):
    """Raise unless ``ok`` (kept under ``python -O``, unlike assert)."""
    if not ok:
        raise RuntimeError(msg)


def cuda_ms(fn, iters=5):
    """Median CUDA-event time of ``fn()`` in ms, after one warm-up call."""
    fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def twin_top2_gap(rows, params):
    """Relative gap between the twin's two largest |DFT|^2 per row."""
    top2 = fused.reference_power(*rows, params).topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]) / top2[:, 0]


def phase2_kernel_vs_twin(dev):
    gen = np.random.RandomState(7)
    for sf in (5, 6, 7):
        for window in (Window.NONE, Window.HANN):
            p = LoraParams(sf=sf, window=window)
            n = p.n
            # clean rows: dechirped chirps (tones), derotated at a random
            # start phase and a rate of at most 0.3 bin
            payload = torch.from_numpy(gen.randint(0, 256, (64, 32)).astype(np.uint8)).to(dev)
            dr, di = planar.dechirp_planar(*planar.modulate_planar(modem.encode(payload), p), p)
            cr, ci = dr.reshape(-1, n).contiguous(), di.reshape(-1, n).contiguous()
            b = cr.shape[0]
            start = torch.from_numpy(gen.uniform(-300, 300, b).astype(np.float32)).to(dev)
            rate = torch.from_numpy((gen.uniform(-0.3, 0.3, b) * 2 * np.pi / n)
                                    .astype(np.float32)).to(dev)
            k = fused.fused_detect_rows(cr, ci, start, rate, p)
            r = fused.fused_detect_rows_reference(cr, ci, start, rate, p)
            clean_diff = int((k != r).sum())
            check(clean_diff == 0, f"SF{sf} {window.name}: {clean_diff} clean rows differ")
            # noise rows
            b = 65536
            rows = [torch.from_numpy(a).to(dev) for a in (
                gen.randn(b, n).astype(np.float32), gen.randn(b, n).astype(np.float32),
                gen.uniform(-300, 300, b).astype(np.float32),
                gen.uniform(-0.5, 0.5, b).astype(np.float32))]
            k = fused.fused_detect_rows(*rows, p)
            r = fused.fused_detect_rows_reference(*rows, p)
            differ = (k != r).nonzero().flatten()
            near_ties = 0
            if differ.numel():
                gap = twin_top2_gap([t[differ] for t in rows], p)
                near_ties = int((gap <= NEAR_TIE_REL).sum())
                check(near_ties == differ.numel(),
                      f"SF{sf} {window.name}: {differ.numel() - near_ties} noise rows "
                      f"differ beyond a {NEAR_TIE_REL:g} near-tie")
            print(f"phase 2: SF{sf} window={window.name}: {cr.shape[0]} clean rows equal; "
                  f"{b} noise rows, {differ.numel()} differ, all at near-ties "
                  f"(top-2 within {NEAR_TIE_REL:g} relative)", flush=True)
    p = LoraParams(sf=7)
    x = torch.zeros(1, p.n, device=dev)
    x[0, ::2] = 1.0
    z = torch.zeros(1, device=dev)
    tie = int(fused.fused_detect_rows(x, torch.zeros_like(x), z, z, p)[0])
    check(tie == 0, f"tie row gave bin {tie}")
    print("phase 2: alternating-impulse tie row -> bin 0", flush=True)


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: "
                           "torch.cuda.is_available() is false")
    # phase 0: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"phase 0: torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}", flush=True)

    # phase 1: build and load
    t0 = time.perf_counter()
    _build.build(force=True, verbose=True)
    _build.load_library()
    print(f"phase 1: built {_build.LIBRARY.name} for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # phase 2: the kernel against its plain twin
    phase2_kernel_vs_twin(dev)
    record = phase3_4_main_path(dev, card)

    check("jax" not in sys.modules, "the port imported JAX")
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


def phase3_4_main_path(dev, card):
    """Phases 3 and 4; returns the kernel's record for the JSON line."""
    p = LoraParams(sf=7)
    pool = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (POOL, PAYLOAD_LEN)).astype(np.uint8)).to(dev)
    reps = CHANNELS * FRAMES // POOL
    full = pool.repeat(reps, 1).reshape(CHANNELS, FRAMES, PAYLOAD_LEN)
    total_samples = CHANNELS * FRAMES * (2 * PAYLOAD_LEN + 2) * p.step
    torch.cuda.synchronize()

    fused.LAUNCHES = 0
    syms = modem.encode(full)
    re, im = planar.modulate_planar(syms, p)
    xr, xi = planar.dechirp_planar(re, im, p)
    del re, im                          # one 4.4 GB batch live, as bench.py
    res = planar.demodulate_planar(xr, xi, p, fused=True)
    decoded = modem.decode(res.symbols)
    torch.cuda.synchronize()
    launches = fused.LAUNCHES

    check(tuple(xr.shape) == (CHANNELS, FRAMES, total_samples // (CHANNELS * FRAMES)),
          f"dechirped planes have shape {tuple(xr.shape)}")
    check(tuple(res.symbols.shape) == (CHANNELS, FRAMES, 2 * PAYLOAD_LEN),
          f"symbols have shape {tuple(res.symbols.shape)}")
    check(torch.equal(decoded, full), "fused demod: decoded payloads differ")
    check(bool((res.sync_word == 0x12).all()), "fused demod: sync word is not 0x12")
    check(bool(torch.isfinite(res.cfo).all() and torch.isfinite(res.time_offset).all()),
          "fused demod: non-finite cfo / time_offset")
    check(launches > 0, "the main path did not launch the fused kernel")
    print(f"phase 3: {CHANNELS * FRAMES} frames ({total_samples / 1e6:.1f} M IQ samples) "
          f"decoded bit-exact through fused=True, sync 0x12 everywhere, "
          f"kernel launches {launches}", flush=True)

    t_enc = cuda_ms(lambda: modem.encode(full))
    t_tx = cuda_ms(lambda: planar.modulate_planar(syms, p))
    re, im = planar.modulate_planar(syms, p)
    t_dech = cuda_ms(lambda: planar.dechirp_planar(re, im, p))
    del re, im
    t_fused = cuda_ms(lambda: planar.demodulate_planar(xr, xi, p, fused=True))
    t_dec = cuda_ms(lambda: modem.decode(res.symbols))
    print(f"phase 3: {card}: encode {t_enc:.3f} ms, modulate_planar {t_tx:.3f} ms "
          f"({total_samples / t_tx / 1e6:.3f} Gsamples/s), dechirp_planar {t_dech:.3f} ms, "
          f"demodulate_planar(fused=True) {t_fused:.3f} ms "
          f"({total_samples / t_fused / 1e6:.3f} Gsamples/s), decode {t_dec:.3f} ms",
          flush=True)

    # phase 4: the plain path, and the kernel against its twin on the main
    # path's own rows
    plain = planar.demodulate_planar(xr, xi, p, fused=False)
    check(torch.equal(plain.symbols, res.symbols), "fused=False symbols differ")
    check(torch.equal(plain.sync_word, res.sync_word), "fused=False sync words differ")
    t_plain = cuda_ms(lambda: planar.demodulate_planar(xr, xi, p, fused=False))
    print(f"phase 4: {card}: demodulate_planar fused=True {t_fused:.3f} ms, "
          f"fused=False (plain torch) {t_plain:.3f} ms "
          f"({total_samples / t_plain / 1e6:.3f} Gsamples/s); same symbols", flush=True)

    yr, yi, rate, t_off, scale, _, _ = planar._demod_stage_planar(xr, xi, p, False, None)
    yr, yi = yr * scale[..., None, None], yi * scale[..., None, None]
    rows = fused.symbol_rows(yr, yi, rate, t_off, p)
    del yr, yi, xr, xi
    k = fused.fused_detect_rows(*rows, p)
    r = fused.fused_detect_rows_reference(*rows, p)
    max_abs_err = int((k.to(torch.int64) - r.to(torch.int64)).abs().max())
    check(max_abs_err == 0, f"kernel vs twin on the main-path rows: {max_abs_err}")
    t_kernel = cuda_ms(lambda: fused.fused_detect_rows(*rows, p), iters=10)
    t_twin = cuda_ms(lambda: fused.fused_detect_rows_reference(*rows, p), iters=10)
    n_rows = rows[0].shape[0]
    print(f"phase 4: {card}: fused_detect_rows on {n_rows} rows x N={p.n}: "
          f"CUDA kernel {t_kernel:.3f} ms ({8 * p.n ** 2 * n_rows / t_kernel / 1e9:.2f} "
          f"TFLOP/s), plain twin {t_twin:.3f} ms; bins equal; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB", flush=True)

    return {"name": "fused_demod", "route": "cuda",
            "source": "lora_phy_tpu_torch/csrc/fused_demod.cu",
            "replaces": "lora_phy_tpu/ops/pallas_demod.py:53",
            "launches": launches, "max_abs_err": max_abs_err,
            "ms": t_kernel, "plain_ms": t_twin}


if __name__ == "__main__":
    main()
