#!/usr/bin/env python3
"""Where the PyTorch port's fused kernel spends its time on one card:
``lora_phy_tpu_torch/csrc/fused_demod.cu`` against copies of itself with
parts taken out.

    python3 tools/torch_kernel_ablation.py [--n 128] [--rows R] [--rounds 3]

The variants, each the kernel's source with statements replaced (every
anchor is asserted, so an edit of the kernel that moves one fails here
rather than timing the wrong thing):

- ``kernel``: the source as shipped;
- ``no_fft``: both FFT passes of the N = 32..128 kernel removed (loads,
  scale, derotation, transpose and argmax stay);
- ``no_sincos``: ``sincosf`` replaced by two moves (the phase and the
  rotation stay), at every N;
- ``loads_derotate``: both removed.

At N <= 16 (one thread a row, no FFT anchors) only ``kernel`` and
``no_sincos`` run.

All are compiled at once by nvcc with the package's flags
(``_build.compile_library``) into ``build/lora_phy_tpu_torch/ablation/``
and launched through the same C entry point on the same noise rows of N
(default 128) with a per-row scale (start in +-300 rad, rate in +-0.5 rad
per sample), at the bench shape's samples (553,648,128 / N rows).
Torch's two row sums over the same planes are timed as a yardstick of
reading them. Each is timed in interleaved rounds (CUDA events over 10
launches after a warm-up); one JSON line per variant and round, with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from lora_phy_tpu_torch import _build, device_table  # noqa: E402
from lora_phy_tpu_torch.ops import fused_demod  # noqa: E402

SINCOS = "sincosf(ph, &s, &c);"
FFT_R = "fft_dif<kR, 0, kR>(re, im, w_r);"
FFT_G = "fft_each<G, kM, kR>(ur, ui, w_g);"
VARIANTS = {
    "kernel": [],
    "no_fft": [(FFT_R, ""), (FFT_G, "")],
    "no_sincos": [(SINCOS, "s = ph; c = rt;")],
    "loads_derotate": [(SINCOS, "s = ph; c = rt;"), (FFT_R, ""), (FFT_G, "")],
}


def variants_for(n: int):
    """The VARIANTS whose anchors reach the kernel that N dispatches to:
    the FFT anchors are in the N = 32..128 kernel only."""
    return {name: edits for name, edits in VARIANTS.items()
            if n >= 32 or all(old == SINCOS for old, _ in edits)}


def variant_source(edits) -> str:
    """The kernel's source with ``edits`` ((old, new) pairs) applied."""
    src = _build.SOURCES[0].read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor {old!r} is not in {_build.SOURCES[0].name} once")
        src = src.replace(old, new)
    return src


def build_variant(name: str, edits) -> ctypes.CDLL:
    out = _build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{name}.cu"
    cu.write_text(variant_source(edits))
    return _build.declare(ctypes.CDLL(str(_build.compile_library([cu], out / f"{name}.so"))),
                          fused_demod.ENTRY)


def events_ms(fn, launches=10) -> float:
    """Mean CUDA-event time of ``fn()`` over ``launches`` calls after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(launches):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=128, choices=fused_demod.CUDA_N)
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ablation.py needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
    n = args.n
    variants = variants_for(n)
    with ThreadPoolExecutor(len(variants)) as pool:
        libs = dict(zip(variants, pool.map(build_variant, variants, variants.values())))

    dev = torch.device("cuda", 0)
    b = args.rows or 553_648_128 // n
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    xr = torch.randn(b, n, device=dev, generator=gen)
    xi = torch.randn(b, n, device=dev, generator=gen)
    start = torch.rand(b, device=dev, generator=gen) * 600 - 300
    rate = torch.rand(b, device=dev, generator=gen) - 0.5
    scale = torch.rand(b, device=dev, generator=gen) * 0.8 + 0.2
    twiddle = device_table(fused_demod._twiddles, n, device=dev)
    out = torch.empty(b, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launcher(lib):
        def call():
            rc = lib.lora_fused_demod(xr.data_ptr(), xi.data_ptr(), start.data_ptr(),
                                      rate.data_ptr(), scale.data_ptr(), None,
                                      twiddle.data_ptr(), out.data_ptr(), b, n, stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: {lib.lora_cuda_error_string(rc).decode()}")
        return call

    for rnd in range(args.rounds):
        timed = {"torch_sum_both_planes": lambda: (xr.sum(-1), xi.sum(-1))}
        timed.update((name, launcher(lib)) for name, lib in libs.items())
        for name, fn in timed.items():
            print(json.dumps({"card": card, "round": rnd, "variant": name, "n": n, "rows": b,
                              "ms": events_ms(fn)}), flush=True)


if __name__ == "__main__":
    main()
