"""Plain reference of the bulk coded decoder: frame-aligned captures (the
two sync-word chirps, then the coded payload chirps) to symbols, offsets
and bytes, written as the straightforward steps on whole symbol windows,
in plain torch on any device, in the precision asked for (:mod:`.dft`).
The steps are those of the reference library's working demodulator
(``lora_demodulate`` after the external dechirp):

1. Dechirp: every symbol window times the base down-chirp.
2. Scale: where the largest magnitude of either plane of the frame
   exceeds 1, the frame is scaled by its inverse.
3. Offsets from the two sync windows: each window's first peak bin plus
   its fractional bin ``0.5 (r - l) / (2 p - r - l)``; their mean over
   ``N`` is the coarse CFO; the phase advance of the peak from the first
   window to the second, wrapped into [-pi, pi], over ``2 pi N`` is the
   fine CFO; the CFO is their sum. The timing offset is minus the mean
   peak's fractional part (to the nearest bin) times ``N``.
4. Windows: with the timing offset rounded half away from zero to ``t``
   samples, symbol ``s`` is read from ``s N + t`` where that window lies
   inside the frame, else from ``s N``.
5. Each window times ``exp(-2 pi i cfo j / N)`` (``j`` = 0 .. N-1) and the
   scale, DFT'd: the symbol is the first bin of greatest magnitude. The
   sync byte is the top nibbles of the first two symbols.
6. The coded chain's decoder (:mod:`.coding`) on the data symbols.

Nothing here imports the program; the inputs are the benchmark's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import chirp, coding
from .dft import mag2, peak_detect, real_dtype


def _windows(xr, xi, n, precision):
    dt = real_dtype(precision)
    f, length = xr.shape
    s = length // n
    dr, di = (torch.as_tensor(a, device=xr.device).to(dt) for a in chirp.base_downchirp(n))
    ar = xr[:, : s * n].reshape(f, s, n).to(dt)
    ai = xi[:, : s * n].reshape(f, s, n).to(dt)
    return ar * dr - ai * di, ar * di + ai * dr


def offsets(yr, yi, n, precision):
    """(scale [F], cfo [F], time_offset [F]) from dechirped windows
    [F, S, N]."""
    amax = torch.maximum(yr.abs().amax(dim=(-2, -1)), yi.abs().amax(dim=(-2, -1)))
    scale = torch.where(amax > 1.0, 1.0 / amax, torch.ones_like(amax))
    er, ei = yr[:, :2] * scale[:, None, None], yi[:, :2] * scale[:, None, None]
    _, idx, frac, phase = peak_detect(er, ei, precision)
    avg = torch.sum(idx.to(frac.dtype) + frac, dim=-1) / 2.0
    d = phase[:, 1] - phase[:, 0]
    d = torch.where(d > math.pi, d - 2.0 * math.pi, d)
    d = torch.where(d < -math.pi, d + 2.0 * math.pi, d)
    cfo = avg / n + d / (2.0 * math.pi * n)
    time_offset = -(avg - torch.floor(avg + 0.5)) * n
    return scale, cfo, time_offset


def spectra(yr, yi, scale, cfo, time_offset, n, precision):
    """|DFT|^2 [F, S, N] of the derotated windows at the given offsets."""
    dt = real_dtype(precision)
    f, s, _ = yr.shape
    t = torch.where(time_offset >= 0, torch.floor(time_offset + 0.5),
                    torch.ceil(time_offset - 0.5)).to(torch.int64)       # [F]
    base = torch.arange(s, device=yr.device) * n                        # [S]
    shifted = (((t[:, None] > 0) & (base + t[:, None] + n <= s * n))
               | ((t[:, None] < 0) & (-t[:, None] <= base)))            # [F, S]
    first = torch.where(shifted, base + t[:, None], base)               # [F, S]
    idx = first[..., None] + torch.arange(n, device=yr.device)          # [F, S, N]
    flat_r, flat_i = yr.reshape(f, -1), yi.reshape(f, -1)
    wr = torch.gather(flat_r, 1, idx.reshape(f, -1)).reshape(f, s, n)
    wi = torch.gather(flat_i, 1, idx.reshape(f, -1)).reshape(f, s, n)
    j = torch.arange(n, device=yr.device, dtype=dt)
    ang = (-2.0 * math.pi / n) * cfo.to(dt)[:, None] * j
    c_ = (torch.cos(ang) * scale[:, None])[:, None, :]
    s_ = (torch.sin(ang) * scale[:, None])[:, None, :]
    return mag2(wr * c_ - wi * s_, wr * s_ + wi * c_, precision)


def demodulate(xr, xi, config, precision, chunk=4096):
    """[F, L] raw frames -> dict of host arrays: symbols [F, S-2], sync,
    cfo, time_offset [F]."""
    n, shift = 1 << config["sf"], max(config["sf"] - 4, 0)
    out = {"symbols": [], "sync": [], "cfo": [], "time_offset": []}
    for a in range(0, xr.shape[0], chunk):
        yr, yi = _windows(xr[a:a + chunk], xi[a:a + chunk], n, precision)
        scale, cfo, t_off = offsets(yr, yi, n, precision)
        bins = torch.argmax(spectra(yr, yi, scale, cfo, t_off, n, precision), dim=-1)
        out["sync"].append(((((bins[:, 0] >> shift) & 0xF) << 4)
                            | ((bins[:, 1] >> shift) & 0xF)).cpu().numpy())
        out["symbols"].append(bins[:, 2:].cpu().numpy())
        out["cfo"].append(cfo.cpu().numpy())
        out["time_offset"].append(t_off.cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}


def reference_outputs(item, config) -> dict:
    """The reference's float64 outputs for one pool item, frames flattened."""
    return demodulate(item.xr.reshape(-1, item.xr.shape[-1]),
                      item.xi.reshape(-1, item.xi.shape[-1]), config, "f64")


def decode(symbols, config):
    """(payload, crc_ok, fec_errors) of [F, S] data symbols."""
    return coding.decode_coded(symbols, config["payload_bytes"], config["sf"], config["cr"])


def judge(item, out: dict, ref: dict, config: dict, precision: str = "f64",
          chunk: int = 4096) -> dict:
    """The parts of the numbers compared (see :mod:`.check`) for one call
    of the program (``out``: host arrays over the batch) against the
    reference (``ref``: its own ``demodulate`` of the same batch, frames
    flattened):

    ``frame_mismatch``  (frames whose sync word or any data symbol
        differs from the first best bins of the reference's spectra at the
        program's own CFO and timing offset, frames);
    ``sym_gap``  the widest relative gap by which a data symbol the
        program decided lies below the best bin of those spectra;
    ``cfo_err``, ``to_err``  per frame, the difference between the
        program's CFO (bins) and timing offset (samples) and the
        reference's own estimates;
    ``decode_mismatch``  frames whose bytes, ``crc_ok`` or
        ``fec_errors`` are not the coded chain's decode of their own
        symbols."""
    n, shift = 1 << config["sf"], max(config["sf"] - 4, 0)
    sym = out["symbols"].reshape(-1, out["symbols"].shape[-1])
    sync = out["sync"].reshape(-1)
    cfo, t_off = out["cfo"].reshape(-1), out["time_offset"].reshape(-1)
    xr = item.xr.reshape(-1, item.xr.shape[-1])
    xi = item.xi.reshape(-1, item.xi.shape[-1])
    gap, differ = 0.0, 0
    for a in range(0, xr.shape[0], chunk):
        yr, yi = _windows(xr[a:a + chunk], xi[a:a + chunk], n, precision)
        scale, _, _ = offsets(yr, yi, n, precision)
        dev = yr.device
        m = spectra(yr, yi, scale, torch.as_tensor(cfo[a:a + chunk], device=dev),
                    torch.as_tensor(t_off[a:a + chunk], device=dev), n, precision)
        bins = torch.argmax(m, dim=-1)
        chosen = torch.as_tensor(sym[a:a + chunk], device=dev)
        ref_sync = (((bins[:, 0] >> shift) & 0xF) << 4) | ((bins[:, 1] >> shift) & 0xF)
        differ += int(((ref_sync != torch.as_tensor(sync[a:a + chunk], device=dev))
                       | torch.any(bins[:, 2:] != chosen, dim=-1)).sum())
        best = m[:, 2:].amax(dim=-1)
        got = torch.gather(m[:, 2:], -1, chosen[..., None])[..., 0]
        gap = max(gap, float(((best - got) / torch.clamp(best, min=1e-30)).max()))
    numbers = {"frame_mismatch": (differ, len(sym)), "sym_gap": gap,
               "cfo_err": np.abs(cfo - ref["cfo"]), "to_err": np.abs(t_off - ref["time_offset"])}
    pay, ok, fec = decode(sym, config)
    bad = (np.any(pay != out["bytes"].reshape(pay.shape), axis=-1)
           | (ok != out["crc_ok"].reshape(-1)) | (fec != out["fec_errors"].reshape(-1)))
    numbers["decode_mismatch"] = int(bad.sum())
    return numbers


def truth_summary(item, out: dict) -> str:
    """Frames whose bytes are those sent, and frames with ``crc_ok``:
    information, not compared."""
    sent = item.payloads.reshape(-1, item.payloads.shape[-1])
    right = np.all(out["bytes"].reshape(sent.shape) == sent, axis=-1)
    return (f"{int(right.sum())} of {len(sent)} frames decoded to the bytes sent, "
            f"{int(out['crc_ok'].sum())} with crc_ok")


class System:
    """The reference in the program's place (the control): the same
    calls, computed in ``precision``."""

    def __init__(self, config: dict, device, precision: str = "tf32"):
        self.config, self.precision = config, precision

    def device(self, item):
        shape = item.xr.shape[:-1]
        r = demodulate(item.xr.reshape(-1, item.xr.shape[-1]),
                       item.xi.reshape(-1, item.xi.shape[-1]), self.config, self.precision)
        pay, ok, fec = decode(r["symbols"], self.config)
        r.update(bytes=pay, crc_ok=ok, fec_errors=fec)
        return {k: v.reshape(*shape, *v.shape[1:]) for k, v in r.items()}

    def readout(self, handle) -> dict:
        return handle

    def outputs(self, handle, host: dict) -> dict:
        return host
