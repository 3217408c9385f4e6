"""SIC collision-recovery sweep: weak-frame recovery rate vs power gap —
the port's twin of ``lora_phy_tpu/runners/sic_sweep.py``.

Monte-Carlo characterisation of the collision receiver (models/sic.py):
two same-SF frames with overlapping payloads, the weak one ``gap`` dB
under the strong one, AWGN at ``--snr`` dB relative to the strong frame
(the reference model's noise convention, tests/awgn_sweep.py:246). Each
trial decodes the block twice — plain single-pass receive and the SIC
loop — and scores exact weak-payload recovery. The CSV:

    gap_db,trials,weak_plain,weak_sic,strong_sic + 95% Wilson interval
    columns for the two weak-recovery rates

The noise comes from a ``torch.Generator`` seeded from ``--seed`` on the
device (the JAX twin draws from ``PRNGKey(seed*100003 + trial)``, so the
two packages agree in distribution); :func:`sweep` takes a ``noise``
callable in its place, through which a caller can inject any draws.

Flags: ``--sf`` ``--snr=DB`` ``--gaps=3,6,9,12,15`` ``--trials=N``
``--payload-len=BYTES`` ``--seed`` ``--out=CSV|-`` ``--device=``
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import device_of
from ._cli import DEVICE_FLAG, device_from, parse_flags

HEADER = ("gap_db,trials,weak_plain,weak_sic,strong_sic,"
          "plain_lo,plain_hi,sic_lo,sic_hi")


def sweep(params, gaps, trials: int, snr_db: float = 20.0, payload_len: int = 6,
          seed: int = 0, device=None, noise=None) -> list[str]:
    """The CSV rows (without the header), one per gap in ``gaps`` (dB).

    ``noise(trial, clean) -> noisy`` maps the clean complex64 collision of
    trial ``trial`` (counted from 0 at every gap, as the JAX twin keys its
    draws) to the received block; by default AWGN at ``snr_db`` from a
    generator seeded with ``seed`` on ``device``."""
    from ..models import modem, sic, stream, sync
    from ..ops.impair import apply_awgn
    from ..utils.stats import wilson

    dev = device_of(None, device)
    if noise is None:
        gen = torch.Generator(device=dev).manual_seed(seed)

        def noise(trial, clean):
            return apply_awgn(gen, clean, snr_db)

    p = params
    n_pay = payload_len * 2
    rng = np.random.RandomState(seed)
    off_a = 2 * p.step
    off_b = off_a + 5 * p.step                  # payloads overlap

    def hits(frames_iter, pay_a, pay_b):
        got_w = got_s = False
        for start, syms in frames_iter:
            if abs(start - off_b) <= 2:
                got_w |= np.array_equal(modem.decode(syms).cpu().numpy(), pay_b)
            if abs(start - off_a) <= 2:
                got_s |= np.array_equal(modem.decode(syms).cpu().numpy(), pay_a)
        return got_w, got_s

    rows = []
    for gap in gaps:
        amp_b = np.float32(10.0 ** (-gap / 20.0))
        weak_plain = weak_sic = strong_sic = 0
        for t in range(trials):
            pay_a = rng.randint(0, 256, payload_len).astype(np.uint8)
            pay_b = rng.randint(0, 256, payload_len).astype(np.uint8)
            fa = stream.frame_modulate(modem.encode(pay_a, device=dev), p)
            fb = stream.frame_modulate(modem.encode(pay_b, device=dev), p) * float(amp_b)
            s = torch.zeros(off_b + fb.numel() + 4 * p.step, dtype=torch.complex64,
                            device=dev)
            s[off_a: off_a + fa.numel()] += fa
            s[off_b: off_b + fb.numel()] += fb
            y = noise(t, s)
            re, im = y.real.contiguous(), y.imag.contiguous()

            blk = sync.receive_block_planar(re, im, p, n_pay, min_power_db=-30.0)
            w0, _ = hits(((r["start"], r["symbols"]) for r in sync.block_rows(blk)),
                         pay_a, pay_b)
            frames, _ = sic.receive_sic_planar(re, im, p, n_pay)
            w1, s1 = hits(((f["start"], f["symbols"]) for f in frames), pay_a, pay_b)
            weak_plain += w0
            weak_sic += w1
            strong_sic += s1
        p_lo, p_hi = wilson(weak_plain, trials)
        s_lo, s_hi = wilson(weak_sic, trials)
        rows.append(f"{gap:g},{trials},{weak_plain},"
                    f"{weak_sic},{strong_sic},"
                    f"{p_lo:.4f},{p_hi:.4f},{s_lo:.4f},{s_hi:.4f}")
        print(rows[-1], file=sys.stderr, flush=True)
    return rows


def main(argv=None) -> int:
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "sf": (int, 7),
        "snr": (float, 20.0),
        "gaps": (lambda v: [float(g) for g in v.split(",")], None),
        "trials": (int, 40),
        "payload-len": (int, 6),
        "seed": (int, 0),
        "out": (str, "-"),
        "device": DEVICE_FLAG,
    })
    dev = device_from(flags)
    if dev is None:
        return 1
    from ..utils.params import LoraParams

    rows = sweep(LoraParams(sf=flags["sf"]),
                 flags["gaps"] or [3.0, 6.0, 9.0, 12.0, 15.0], flags["trials"],
                 snr_db=flags["snr"], payload_len=flags["payload-len"],
                 seed=flags["seed"], device=dev)
    text = "\n".join([HEADER] + rows) + "\n"
    if flags["out"] in ("", "-"):
        sys.stdout.write(text)
    else:
        with open(flags["out"], "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
