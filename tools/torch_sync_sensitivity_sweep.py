"""Streaming-receiver sync + decode rate vs SNR on the PyTorch port — the
twin of ``tools/sync_sensitivity_sweep.py``: the full path, frame-sync
scan through block demod, with the same flags and CSV plus ``--device=``
(default the first CUDA card; ``--device=cpu`` for the CPU).

    python tools/torch_sync_sensitivity_sweep.py [--trials=500] [--out=PATH]
           [--robust] [--soft] [--chunk=128] [--device=cuda:0]

Trials ride the receiver's leading batch dim (one call per chunk of
noisy copies). Every rate column carries a 95% Wilson binomial interval
(``*_lo``/``*_hi``).

Default CSV: ``sf,snr_db,trials,synced,decoded,ml,<CIs>`` — the simple
Hamming84 chain decoded BOTH ways per synced frame on identical noise:
hard argmax+syndrome (``decoded``) and constrained-argmax ML detection
from the receiver's spectra (``ml``, ``soft.hamming84_ml_decode``).
``--soft`` sweeps CODED frames (CR4/8 + CRC) and decodes each synced
frame hard (syndrome) and soft (ML correlation from the receiver's
spectra): ``sf,snr_db,trials,synced,hard,soft,<CIs>``. ``--robust``
sweeps ``pre_acc=3`` instead. ``--tpu``, the JAX tool's switch off the
CPU, is accepted and changes nothing: the card is the default here. The
default ``--out`` lies beside the JAX tool's curve,
``logs/sync_sensitivity_r5_torch.csv``.

The noise of chunk ``ci`` at (SF, SNR) comes from a ``torch.Generator``
seeded with the integer of the JAX tool's ``PRNGKey``
(``sf*1000003 + (snr+64)*911 + ci``), so the two agree in distribution;
:func:`main` and :func:`cell` take a ``noise`` callable in its place
(``noise(sf, snr, ci, b, t) -> (nr, ni)``, unit normal ``[b, t]``
planes), through which a caller can feed both tools the same draws.
"""

import math
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lora_phy_tpu_torch import LoraParams, device_of  # noqa: E402
from lora_phy_tpu_torch.models import coded, modem, soft as softmod  # noqa: E402
from lora_phy_tpu_torch.models import stream, sync  # noqa: E402
from lora_phy_tpu_torch.utils.stats import wilson  # noqa: E402

DEFAULT_OUT = "logs/sync_sensitivity_r5_torch.csv"
SFS = (7, 9, 12)
SNRS = (-3, -6, -9, -12, -15, -18)


def noisy_chunk(base_r, base_i, snr_db: float, nr, ni):
    """``[b, T]`` noisy copies of the base planes from the unit normal
    draws ``nr``, ``ni`` (the reference noise convention: sigma =
    10**(-snr/20), per-component sigma/sqrt(2), in float32)."""
    sig = float(np.float32(10.0 ** (-snr_db / 20.0) / math.sqrt(2.0)))
    dev = base_r.device
    nr = torch.as_tensor(nr, dtype=torch.float32, device=dev)
    ni = torch.as_tensor(ni, dtype=torch.float32, device=dev)
    return base_r[None] + nr * sig, base_i[None] + ni * sig


def generator_noise(device):
    """The default draws: a generator per chunk, seeded as the JAX tool
    keys it."""
    def noise(sf, snr, ci, b, t):
        gen = torch.Generator(device=device).manual_seed(
            sf * 1000003 + (snr + 64) * 911 + ci)
        return (torch.randn((b, t), generator=gen, device=device),
                torch.randn((b, t), generator=gen, device=device))
    return noise


def frame_base(sf: int, soft: bool, device):
    """(payload, n_payload_symbols, cfg or None, offset, base_r, base_i):
    one frame of 8 random bytes (``RandomState(sf)``) at 3 symbols into
    silence with 4 symbols after it."""
    p = LoraParams(sf=sf)
    pl = np.random.RandomState(sf).randint(0, 256, 8).astype(np.uint8)
    cfg = None
    if soft:
        cfg = coded.CodedConfig(sf=sf, cr=4, crc=True)
        n_pay = 8 + coded.payload_symbol_count(pl.size, cfg)
        iq = stream.frame_encode(pl, cfg, p, device=device)
    else:
        n_pay = 16
        iq = stream.frame_modulate(modem.encode(pl, device=device), p)
    off = 3 * p.step
    t_len = off + iq.numel() + 4 * p.step
    base_r = torch.zeros(t_len, dtype=torch.float32, device=device)
    base_i = torch.zeros_like(base_r)
    base_r[off: off + iq.numel()] = iq.real
    base_i[off: off + iq.numel()] = iq.imag
    return pl, n_pay, cfg, off, base_r, base_i


def cell(sf: int, snr: int, trials: int, chunk: int = 128, soft: bool = False,
         pre_acc: int = 1, device=None, noise=None):
    """(synced, hard, soft-or-ml) counts of one (SF, SNR) point over
    ``trials`` noisy copies in chunks of ``chunk``."""
    dev = device_of(None, device)
    noise = noise or generator_noise(dev)
    p = LoraParams(sf=sf)
    pl, n_pay, cfg, off, base_r, base_i = frame_base(sf, soft, dev)
    truth = torch.from_numpy(pl).to(dev)
    synced = n_hard = n_soft = 0
    done = ci = 0
    while done < trials:
        b = min(chunk, trials - done)
        xr, xi = noisy_chunk(base_r, base_i, float(snr),
                             *noise(sf, snr, ci, b, base_r.numel()))
        blk, spec = sync.receive_block_planar(
            xr, xi, p, n_pay, max_frames=2, min_power_db=-30.0,
            pre_acc=pre_acc, with_spectra=True)
        # each trial's first found frame within a step of the true start
        near = blk.found & ((blk.start.to(torch.int64) - off).abs() <= p.step)
        hit = near.any(dim=-1)
        rows = torch.nonzero(hit).reshape(-1)
        ks = torch.argmax(near.to(torch.int8), dim=-1)[rows]
        synced += int(rows.numel())
        if rows.numel():
            syms, sp = blk.symbols[rows, ks], spec[rows, ks]
            if soft:
                nsym = n_pay - 8
                h_pay, h_ok, _ = coded.decode_payload(syms[:, 8: 8 + nsym], pl.size, cfg)
                n_hard += int(((h_pay == truth).all(dim=-1) & h_ok).sum())
                s_pay, s_ok, _ = softmod.decode_payload_soft(sp[:, 8: 8 + nsym],
                                                             pl.size, cfg)
                n_soft += int(((s_pay == truth).all(dim=-1) & s_ok).sum())
            else:
                n_hard += int((modem.decode(syms) == truth).all(dim=-1).sum())
                ml = softmod.hamming84_ml_decode(sp)
                n_soft += int((ml == truth).all(dim=-1).sum())
        done += b
        ci += 1
    return synced, n_hard, n_soft


def main(argv=None, noise=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    trials = 500
    out = DEFAULT_OUT
    pre_acc = 1
    soft = False
    chunk = 128
    device = None
    for a in args:
        if a.startswith("--trials="):
            trials = int(a.split("=", 1)[1])
        elif a.startswith("--out="):
            out = a.split("=", 1)[1]
        elif a.startswith("--chunk="):
            chunk = int(a.split("=", 1)[1])
        elif a == "--robust":
            pre_acc = 3
        elif a == "--soft":
            soft = True
        elif a == "--tpu":
            pass
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            print(f"unknown flag {a}", file=sys.stderr)
            return 1
    dev = device_of(None, device)

    if soft:
        head = ("sf,snr_db,trials,synced,hard,soft,synced_lo,synced_hi,"
                "hard_lo,hard_hi,soft_lo,soft_hi")
    else:
        head = ("sf,snr_db,trials,synced,decoded,ml,synced_lo,synced_hi,"
                "decoded_lo,decoded_hi,ml_lo,ml_hi")
    rows = [head]
    for sf in SFS:
        for snr in SNRS:
            synced, n_hard, n_soft = cell(sf, snr, trials, chunk, soft, pre_acc,
                                          dev, noise)
            s_lo, s_hi = wilson(synced, trials)
            h_lo, h_hi = wilson(n_hard, trials)
            so_lo, so_hi = wilson(n_soft, trials)
            rows.append(
                f"{sf},{snr},{trials},{synced},{n_hard},{n_soft},"
                f"{s_lo:.4f},{s_hi:.4f},{h_lo:.4f},{h_hi:.4f},"
                f"{so_lo:.4f},{so_hi:.4f}")
            print(rows[-1], file=sys.stderr, flush=True)
    pathlib.Path(out).write_text("\n".join(rows) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
