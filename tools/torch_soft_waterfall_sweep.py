"""Frame-loss counts for hard argmax decisions vs soft max-log-LLR ML
decoding through the SF7 waterfall knee on the PyTorch port — the twin of
``tools/soft_waterfall_sweep.py``, with the same flags and CSV, plus
``--device=`` (default the first CUDA card; ``--device=cpu`` for the CPU).

    python tools/torch_soft_waterfall_sweep.py [--frames=400] [--out=PATH]
           [--crs=1,4] [--snrs=-8,-9,-10,-11,-12,-13] [--device=cuda:0]

CSV: ``cr,snr_db,frames,hard_lost,soft_lost`` + 95% Wilson interval
columns for both loss rates. Frame-aligned coded frames (no sync scan);
the hard path is ``demodulate_spectrum_planar``'s argmax +
``coded.decode_payload``, the soft path ``soft.decode_payload_soft`` on
the SAME dechirped planes and noise. The default ``--out`` lies beside
the JAX tool's curve, ``logs/soft_vs_hard_waterfall_r4_torch.csv``.

The noise comes from a ``torch.Generator`` seeded with ``seed`` on the
device (the JAX tool draws from ``PRNGKey(seed)``, so the two agree in
distribution); :func:`losses` takes the two unit normal draws in its
place (``noise=``), so a caller can feed both tools the same draws.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lora_phy_tpu_torch import LoraParams, device_of  # noqa: E402
from lora_phy_tpu_torch.models import coded, soft  # noqa: E402
from lora_phy_tpu_torch.models.coded import CodedConfig  # noqa: E402
from lora_phy_tpu_torch.ops import planar  # noqa: E402
from lora_phy_tpu_torch.ops.impair import add_awgn_draws, apply_awgn  # noqa: E402
from lora_phy_tpu_torch.utils.stats import wilson  # noqa: E402

DEFAULT_OUT = "logs/soft_vs_hard_waterfall_r4_torch.csv"


def losses(cr: int, snr_db: float, n_frames: int, sf=7, payload_len=12,
           seed=0, device=None, noise=None):
    """(hard_lost, soft_lost) over ``n_frames`` frames on identical noise.
    ``noise``: ``(nr, ni)`` unit normal planes of the frames' IQ shape
    (``[n_frames, samples]``) in place of the generator's draws."""
    dev = device_of(None, device)
    p = LoraParams(sf=sf)
    cfg = CodedConfig(sf=sf, cr=cr)
    rng = np.random.RandomState(seed)
    payloads = rng.randint(0, 256, (n_frames, payload_len)).astype(np.uint8)
    bins = coded.encode_payload(payloads, cfg, device=dev)
    re, im = planar.modulate_planar(bins, p)
    iq = torch.complex(re, im)
    if noise is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        noisy = apply_awgn(gen, iq, snr_db)
    else:
        noisy = add_awgn_draws(iq, *noise, snr_db)
    dr, di = planar.dechirp_planar(noisy.real.contiguous(), noisy.imag.contiguous(), p)

    mag2 = planar.demodulate_spectrum_planar(dr, di, p)[0]
    hard, _, _ = coded.decode_payload(torch.argmax(mag2, dim=-1).to(torch.int32),
                                      payload_len, cfg)
    sft, _, _ = soft.decode_payload_soft(mag2, payload_len, cfg)
    truth = torch.from_numpy(payloads).to(dev)
    hard_lost = int((hard != truth).any(dim=-1).sum())
    soft_lost = int((sft != truth).any(dim=-1).sum())
    return hard_lost, soft_lost


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    frames = 400
    out = DEFAULT_OUT
    crs = [1, 4]
    snrs = [-8.0, -9.0, -10.0, -11.0, -12.0, -13.0]
    device = None
    for a in args:
        if a.startswith("--frames="):
            frames = int(a.split("=", 1)[1])
        elif a.startswith("--out="):
            out = a.split("=", 1)[1]
        elif a.startswith("--crs="):
            crs = [int(x) for x in a.split("=", 1)[1].split(",")]
        elif a.startswith("--snrs="):
            snrs = [float(x) for x in a.split("=", 1)[1].split(",")]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            print(f"unknown flag {a}", file=sys.stderr)
            return 1
    dev = device_of(None, device)

    rows = ["cr,snr_db,frames,hard_lost,soft_lost,"
            "hard_lo,hard_hi,soft_lo,soft_hi"]
    for cr in crs:
        for snr in snrs:
            h, s = losses(cr, snr, frames, device=dev)
            h_lo, h_hi = wilson(h, frames)
            s_lo, s_hi = wilson(s, frames)
            rows.append(f"{cr},{snr},{frames},{h},{s},"
                        f"{h_lo:.4f},{h_hi:.4f},{s_lo:.4f},{s_hi:.4f}")
            print(rows[-1], file=sys.stderr, flush=True)
    pathlib.Path(out).write_text("\n".join(rows) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
