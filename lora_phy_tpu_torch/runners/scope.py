"""lora-scope: spectrogram / dechirped-waterfall diagnostics for IQ files —
the port's twin of ``lora_phy_tpu/runners/scope.py``.

Writes a two-panel PNG:

1. STFT waterfall of the raw stream (chirp sweeps are the diagonal
   stripes; interferers, DC spurs and images show up immediately);
2. the up-dechirped per-window spectrum (the synchroniser's view: a
   preamble is a horizontal line at its CFO bin), overlaid with every
   frame the block receiver reports (start marker + sync/payload span).

:func:`panels` computes both spectra (``torch.fft`` on the device) and
the receiver's rows; :func:`render` draws them and is the only place that
imports matplotlib. Without matplotlib the runner prints one line naming
it and exits 1; it writes no PNG any other way.

Flags: ``--in=FILE`` ``--sf`` ``--bw`` ``--osr`` ``--sync``
``--format=cf32|ci16|ci8`` ``--scale`` ``--payload-len=BYTES``
``--thresh=DB`` ``--robust`` ``--out=PNG`` ``--max-samples=N``
``--device=``
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ._cli import (DEVICE_FLAG, bandwidth_flag, device_from, params_from,
                   parse_flags)

_FORMATS = {"cf32": np.float32, "ci16": np.int16, "ci8": np.int8}


def panels(xr: torch.Tensor, xi: torch.Tensor, params, payload_len: int = 16,
           thresh_db: float = -30.0, robust: bool = False):
    """``(stft [nwin, step], upspec [nwin, N], rows)`` of a capture's
    planes, on their device: the |FFT| of every symbol window (fftshifted),
    the |FFT| of every window up-dechirped with the base downchirp and
    decimated to N, and the block receiver's rows (at most 16 frames).
    The planes are cut to whole windows; fewer than two raises."""
    from .. import device_table
    from ..models import sync
    from ..ops.chirp import base_downchirp_planar

    step, n = params.step, params.n
    nwin = xr.shape[-1] // step
    if nwin < 2:
        raise ValueError("input shorter than two symbol windows")
    xr, xi = xr[: nwin * step], xi[: nwin * step]
    w = torch.complex(xr, xi).reshape(nwin, step)

    # panel 1: raw STFT (window = one symbol period)
    stft = torch.fft.fftshift(torch.fft.fft(w, dim=-1).abs(), dim=-1)

    # panel 2: the synchroniser's view — up-dechirped, decimated spectra
    dr, di = device_table(base_downchirp_planar, params.sf, params.scale,
                          params.osr, device=xr.device)
    dech = (w * torch.complex(dr, di)).reshape(nwin, n, params.osr)[:, :, 0]
    upspec = torch.fft.fft(dech, dim=-1).abs()

    blk = sync.receive_block_planar(
        xr.contiguous(), xi.contiguous(), params, payload_len * 2,
        max_frames=16, min_power_db=thresh_db, pre_acc=3 if robust else 1)
    return stft, upspec, sync.block_rows(blk)


def render(out, title_in: str, params, stft, upspec, rows) -> None:
    """Draw the two panels and the rows' annotations into the PNG ``out``
    (imports matplotlib; raises ``ModuleNotFoundError`` without it)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    step, n = params.step, params.n
    stft, upspec = stft.cpu().numpy(), upspec.cpu().numpy()
    nwin = stft.shape[0]
    db = lambda a: 20.0 * np.log10(np.maximum(a, 1e-6))  # noqa: E731
    fig, (ax0, ax1) = plt.subplots(2, 1, figsize=(16, 8), sharex=True)
    ax0.imshow(db(stft).T, aspect="auto", origin="lower",
               extent=(0, nwin, -step / 2, step / 2), cmap="viridis")
    ax0.set_ylabel("frequency bin (raw)")
    ax0.set_title(f"{title_in} — STFT waterfall "
                  f"(SF{params.sf}, {nwin} symbol windows)")
    ax1.imshow(db(upspec).T, aspect="auto", origin="lower",
               extent=(0, nwin, 0, n), cmap="magma")
    ax1.set_ylabel("up-dechirped bin")
    ax1.set_xlabel("symbol window")
    for r in rows:
        w0 = r["start"] / step
        ax1.axvline(w0, color="w", ls="--", lw=1.0)
        ax1.annotate(
            f"sync=0x{r['sync']:02x} cfo={r['cfo_bins']} "
            f"snr={r['snr_db']:.0f}dB",
            (w0, n * 0.92), color="w", fontsize=8)
    ax1.set_title(f"up-dechirped (synchroniser view) — {len(rows)} frame(s) detected")
    fig.tight_layout()
    fig.savefig(out, dpi=100)
    plt.close(fig)


def main(argv=None) -> int:
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "in": (str, ""),
        "sf": (int, 7),
        "bw": (bandwidth_flag, None),
        "osr": (int, 1),
        "sync": (lambda v: int(v, 0), 0x12),
        "format": (str, "cf32"),
        "scale": (float, 1.0),
        "payload-len": (int, 16),
        "thresh": (float, -30.0),
        "robust": (None, False),
        "out": (str, "scope.png"),
        "max-samples": (int, 1 << 21),
        "device": DEVICE_FLAG,
    })
    if flags["format"] not in _FORMATS:
        print(f"Unknown --format={flags['format']}", file=sys.stderr)
        return 1
    if not flags["in"]:
        print("Need --in=FILE", file=sys.stderr)
        return 1
    dev = device_from(flags)
    if dev is None:
        return 1
    params = params_from({k: v for k, v in flags.items() if v is not None})

    from .. import runtime

    raw = np.fromfile(flags["in"], _FORMATS[flags["format"]])
    raw = raw[: 2 * flags["max-samples"]]
    re, im = runtime.to_planar(raw, flags["scale"])
    if re.size // params.step < 2:
        print("input shorter than two symbol windows", file=sys.stderr)
        return 1
    stft, upspec, rows = panels(
        torch.from_numpy(re).to(dev), torch.from_numpy(im).to(dev), params,
        flags["payload-len"], flags["thresh"], flags["robust"])
    try:
        render(flags["out"], flags["in"], params, stft, upspec, rows)
    except ModuleNotFoundError as e:
        if e.name != "matplotlib":
            raise
        print("scope needs matplotlib, which is not installed: no PNG written",
              file=sys.stderr)
        return 1
    print(f"wrote {flags['out']} ({len(rows)} frames annotated)",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
