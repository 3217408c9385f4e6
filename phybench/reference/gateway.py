"""Plain reference of the gateway block receiver: what a block receiver
for LoRa frames (``preamble_len`` up-chirps, the sync pair, 2.25
down-chirps, the payload) reports for each channel of one block, written
as the straightforward sequence of steps on whole symbol windows, in
plain torch on any device, in the precision asked for
(:mod:`.dft`).

1. Scan. Every symbol window of the block is dechirped both ways (times
   the base down-chirp, and times its conjugate) and DFT'd. A preamble is
   a run of at least ``preamble_len - 2`` windows whose up-dechirp peaks
   sit within one bin of each other; its last window must be followed,
   one to five windows later, by a pair of down-dechirp peaks within one
   bin where the down-dechirp dominates. The up and down peak bins give
   the integer CFO (their mean) and the timing (half their difference);
   the run's last up-dechirp peak must reach ``min_power_db`` (0 dB: a
   full-scale chirp).
2. The first ``max_frames`` such candidates of each channel. Each start
   is tested against one symbol earlier and one later by the up-dechirp
   peak of the second sync window plus the down-dechirp peak of the
   first down-chirp window (the reported start wins a tie, then the
   earlier one); a frame must start inside the block and end inside it.
3. Every window of the frame at its start, the integer CFO taken out
   sample by sample, dechirped. The residual CFO: the mean of the
   preamble windows' signed peak bins plus their fractional bins
   (coarse), and the mean phase advance of the peak from window to
   window less the modulator's own advance (fine, modulo one bin), the
   coarse term picking the whole bins. Each peak's phase is read off the
   frame's own window, with the DFT's time origin at the window's first
   sample. Where the preamble windows' peak bins differ, the phase
   advance between two bins depends on where a receiver puts that
   origin (one that reads windows off the block's grid, ``q = start mod
   N`` samples before the window, measures ``2 pi q`` times the bins'
   difference over ``N`` more): such a frame is flagged ``one_bin``
   False, and :func:`judge` does not hold its residual CFO against this
   one.
4. The sync and payload windows derotated by the residual CFO, DFT'd:
   each symbol is the first bin of greatest magnitude; the sync byte is
   the top nibbles of the two sync symbols. SNR: the payload's mean peak
   power over its mean power in the other bins, in dB. Clock drift: the
   mean change, window to window, of the payload peaks' fractional bins
   ``r / (p + r)`` (or ``-l / (p + l)`` where the left neighbour is the
   larger) before the residual derotation, wrapped to half a bin, in ppm
   of the symbol's ``N`` bins.

The timing offset of such a receiver at one sample per chip is 0.

Nothing here imports the program; the inputs are the benchmark's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import chirp, coding
from .check import DIFFER
from .dft import dft, peak_detect, real_dtype

FIELDS = ("found", "start", "cfo_bins", "sync", "symbols", "cfo", "time_offset",
          "snr_db", "sro_ppm", "one_bin")


def _n(config):
    return 1 << config["sf"]


def _overhead(config):
    n = _n(config)
    return (config["preamble_len"] + 2) * n + 2 * n + n // 4


def _down(n, device, dt):
    dr, di = chirp.base_downchirp(n)
    return torch.as_tensor(dr, device=device).to(dt), torch.as_tensor(di, device=device).to(dt)


def _adjacent(a, b, n):
    d = torch.remainder(a - b, n)
    return (d == 0) | (d == 1) | (d == n - 1)


def scan(xr, xi, config, precision):
    """Per window of every channel ([C, W]): (valid, start, cfo_bins)."""
    n, pre = _n(config), config["preamble_len"]
    dt = real_dtype(precision)
    c, t = xr.shape
    w_count = t // n
    dev = xr.device
    ar = xr[:, : w_count * n].reshape(c, w_count, n).to(dt)
    ai = xi[:, : w_count * n].reshape(c, w_count, n).to(dt)
    dr, di = _down(n, dev, dt)
    mu = _mag2(ar * dr - ai * di, ar * di + ai * dr, precision)
    md = _mag2(ar * dr + ai * di, ai * dr - ar * di, precision)
    up_peak, ub = mu.max(dim=-1)
    dn_peak, db = md.max(dim=-1)
    del mu, md
    w = torch.arange(w_count, device=dev)
    false1 = torch.zeros(c, 1, dtype=torch.bool, device=dev)
    eq = torch.cat([false1, _adjacent(ub[:, 1:], ub[:, :-1], n)], dim=-1)
    last_false = torch.cummax(torch.where(eq, -1, w), dim=-1).values
    run = 1 + w - last_false
    eq_next = torch.cat([eq[:, 1:], false1], dim=-1)
    is_end = (run >= max(2, pre - 2)) & ~eq_next
    dn_pair = torch.cat([_adjacent(db[:, 1:], db[:, :-1], n) & (dn_peak > up_peak)[:, :-1],
                         false1], dim=-1)

    def later(a, o):
        return torch.cat([a[:, o:], torch.zeros_like(a[:, :o])], dim=-1)

    has_dn = torch.zeros_like(is_end)
    dn_raw = torch.zeros_like(db)
    for o in range(5, 0, -1):            # the nearest pair wins
        h = later(dn_pair, o) & (w + o < w_count - 1)
        dn_raw = torch.where(h, later(db, o), dn_raw)
        has_dn = has_dn | h

    def signed(b):
        return torch.where(b > n // 2, b - n, b)

    # bin n/2 is either sign: take the signs that make |up + down| least
    # (the smaller CFO), the first such in the order (u,d) (u,d') (u',d) (u',d')
    bu, bd = signed(ub), signed(dn_raw)
    bu2 = torch.where(ub == n // 2, bu - n, bu)
    bd2 = torch.where(dn_raw == n // 2, bd - n, bd)
    sums = torch.stack([(bu + bd).abs(), (bu + bd2).abs(), (bu2 + bd).abs(), (bu2 + bd2).abs()])
    pick = torch.argmin(sums, dim=0)     # first minimum
    bu = torch.where((pick == 2) | (pick == 3), bu2, bu)
    bd = torch.where((pick == 1) | (pick == 3), bd2, bd)
    tau = torch.round((bd - bu).to(torch.float64) / 2.0).to(torch.int64)
    cfo_bins = torch.round((bd + bu).to(torch.float64) / 2.0).to(torch.int64)
    start = (w - (pre - 1)) * n + tau
    power_db = (10.0 * torch.log10(torch.clamp(up_peak.to(torch.float64), min=1e-30))
                - 20.0 * math.log10(n))
    valid = (is_end & has_dn & (start + n >= 0)
             & (power_db >= float(np.float32(config["min_power_db"]))))
    return valid, start, cfo_bins


def _mag2(xr, xi, precision):
    yr, yi = dft(xr, xi, precision)
    return yr * yr + yi * yi


def _segments(plane, chan, start, length, pad):
    """[L, length] samples ``plane[chan, start : start + length]``, zeros
    outside the block."""
    padded = torch.nn.functional.pad(plane, (pad, pad + length))
    s = torch.clamp(start + pad, 0, padded.shape[-1] - length)
    idx = s[:, None] + torch.arange(length, device=plane.device)
    return padded[chan[:, None], idx]


def _peak_only(xr, xi, precision):
    return _mag2(xr, xi, precision).amax(dim=-1)


def frames(xr, xi, config, precision, chan, start0, cfo_bins):
    """Steps 2-4 for candidate lanes (``chan``, ``start0``, ``cfo_bins``
    [L]): dict of per-lane fields (``found`` is only the probe's and the
    block's test)."""
    n, pre = _n(config), config["preamble_len"]
    s_pay = 2 * config["payload_bytes"]
    t = xr.shape[-1]
    dt = real_dtype(precision)
    dev = xr.device
    dr, di = _down(n, dev, dt)
    pad = 4 * n
    overhead = _overhead(config)

    def window(off, length=n):
        return (_segments(xr, chan, off, length, pad).to(dt),
                _segments(xi, chan, off, length, pad).to(dt))

    def probe(s):
        ur, ui = window(s + (pre + 1) * n)
        vr, vi = window(s + (pre + 2) * n)
        return (_peak_only(ur * dr - ui * di, ur * di + ui * dr, precision)
                + _peak_only(vr * dr + vi * di, vi * dr - vr * di, precision))

    scores = torch.stack([probe(start0), probe(start0 - n), probe(start0 + n)])
    hyp = torch.argmax(scores, dim=0)
    start = start0 + torch.where(hyp == 1, -n, torch.where(hyp == 2, n, 0))
    fits = (start >= 0) & (start + overhead + s_pay * n <= t)

    out = {"start": start, "cfo_bins": cfo_bins, "fits": fits}
    out.update(demod_at(xr, xi, config, precision, chan, start, cfo_bins))
    return out


def _dechirped(xr, xi, config, precision, chan, start, cfo_bins):
    """Dechirped [L, W, N] windows of the preamble, the sync pair and the
    payload at ``start``, the integer CFO taken out."""
    n, pre = _n(config), config["preamble_len"]
    s_pay = 2 * config["payload_bytes"]
    dt = real_dtype(precision)
    dev = xr.device
    dr, di = _down(n, dev, dt)
    pad = 4 * n
    offs = torch.cat([torch.arange(pre + 2, device=dev) * n,
                      _overhead(config) + torch.arange(s_pay, device=dev) * n])
    pos = start[:, None] + offs[None, :]                              # [L, W]
    j = torch.arange(n, device=dev)
    lanes = chan[:, None].expand_as(pos).reshape(-1)
    sr = _segments(xr, lanes, pos.reshape(-1), n, pad).reshape(*pos.shape, n).to(dt)
    si = _segments(xi, lanes, pos.reshape(-1), n, pad).reshape(*pos.shape, n).to(dt)
    # integer CFO out: exp(-2 pi i c (pos + j) / N), the angle reduced first
    k = torch.remainder(cfo_bins[:, None, None] * (pos[..., None] + j), n).to(dt)
    ang = (-2.0 * math.pi / n) * k
    c_, s_ = torch.cos(ang), torch.sin(ang)
    sr, si = sr * c_ - si * s_, sr * s_ + si * c_
    return sr * dr - si * di, sr * di + si * dr


def residual_cfo(pr, pi, config, precision):
    """Residual CFO in bins from dechirped preamble windows [L, P, N], and
    whether every window's peak sits at one bin ([L] bool)."""
    n = _n(config)
    _, idx, frac, phase = peak_detect(pr, pi, precision)
    sb = torch.remainder(idx + n // 2, n) - n // 2
    coarse = torch.mean(sb.to(frac.dtype) + frac, dim=-1)
    d = phase[:, 1:] - phase[:, :-1] - chirp.preamble_phase_step(n)
    d = torch.remainder(d + math.pi, 2.0 * math.pi) - math.pi
    fine = torch.mean(d, dim=-1) / (2.0 * math.pi)
    return fine + torch.round(coarse - fine), torch.all(idx == idx[:, :1], dim=-1)


def demod_spectra(yr, yi, cfo, config, precision):
    """|DFT|^2 [L, S, N] of dechirped windows [L, S, N] derotated by the
    residual CFO ``cfo`` [L] (bins)."""
    n = _n(config)
    dt = real_dtype(precision)
    j = torch.arange(n, device=yr.device, dtype=dt)
    ang = (-2.0 * math.pi / n) * cfo.to(dt)[:, None] * j                # [L, N]
    c_, s_ = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    return _mag2(yr * c_ - yi * s_, yr * s_ + yi * c_, precision)


def demod_at(xr, xi, config, precision, chan, start, cfo_bins, cfo=None):
    """Steps 3-4 at given starts and integer CFOs; with ``cfo`` given
    (the residual, bins) it is used instead of the estimate, and
    ``one_bin`` is None."""
    n, pre, sf = _n(config), config["preamble_len"], config["sf"]
    yr, yi = _dechirped(xr, xi, config, precision, chan, start, cfo_bins)
    one_bin = None
    if cfo is None:
        cfo, one_bin = residual_cfo(yr[:, :pre], yi[:, :pre], config, precision)
    m = demod_spectra(yr[:, pre:], yi[:, pre:], cfo, config, precision)   # [L, 2+S, N]
    bins = torch.argmax(m, dim=-1)
    shift = max(sf - 4, 0)
    sync = (((bins[:, 0] >> shift) & 0xF) << 4) | ((bins[:, 1] >> shift) & 0xF)
    pay = m[:, 2:]
    peak = pay.amax(dim=-1)
    noise = (pay.sum(dim=-1) - peak) / (n - 1)
    snr = 10.0 * torch.log10(peak.mean(dim=-1) / torch.clamp(noise.mean(dim=-1), min=1e-30))
    return {"sync": sync, "symbols": bins[:, 2:], "cfo": cfo, "snr_db": snr,
            "sro_ppm": sro_ppm(yr[:, pre + 2:], yi[:, pre + 2:], config, precision),
            "spectra": m, "one_bin": one_bin}


def sro_ppm(yr, yi, config, precision):
    """Clock drift in ppm from dechirped payload windows [L, S, N]."""
    n = _n(config)
    m = _mag2(yr, yi, precision)
    idx = torch.argmax(m, dim=-1)
    peak = torch.sqrt(m.amax(dim=-1))
    left = torch.sqrt(torch.gather(m, -1, ((idx - 1) % n)[..., None])[..., 0])
    right = torch.sqrt(torch.gather(m, -1, ((idx + 1) % n)[..., None])[..., 0])
    den_r, den_l = peak + right, peak + left
    one, zero = torch.ones_like(den_r), torch.zeros_like(den_r)
    fi = torch.where(right >= left,
                     torch.where(den_r > 0, right / torch.where(den_r > 0, den_r, one), zero),
                     -left / torch.where(den_l > 0, den_l, one))
    dd = torch.remainder(fi[:, 1:] - fi[:, :-1] + 0.5, 1.0) - 0.5
    return 1e6 * torch.mean(dd, dim=-1) / n


def receive(xr, xi, config, precision, chunk=128):
    """The receiver over [C, T] planes, ``chunk`` channels at a time: dict
    of host arrays [C, K] (``symbols`` [C, K, S]); lanes with ``found``
    False are zero."""
    k_max = config["max_frames"]
    out = {f: [] for f in FIELDS}
    for a in range(0, xr.shape[0], chunk):
        out_c = _receive_chunk(xr[a:a + chunk], xi[a:a + chunk], config, precision, k_max)
        for f in FIELDS:
            out[f].append(out_c[f])
    return {f: np.concatenate(v) for f, v in out.items()}


def reference_outputs(item, config) -> dict:
    """The reference's float64 outputs for one pool item."""
    return receive(item.xr, item.xi, config, "f64")


def _receive_chunk(xr, xi, config, precision, k_max):
    c = xr.shape[0]
    s_pay = 2 * config["payload_bytes"]
    valid, start_w, cfo_w = scan(xr, xi, config, precision)
    w_count = valid.shape[-1]
    w = torch.arange(w_count, device=xr.device)
    first = torch.sort(torch.where(valid, w, w_count), dim=-1).values[:, :k_max]
    cand = first < w_count
    pos = torch.where(cand, first, 0)
    chan = torch.arange(c, device=xr.device)[:, None].expand(c, k_max).reshape(-1)
    start0 = torch.gather(start_w, -1, pos).reshape(-1)
    cfo_b = torch.gather(cfo_w, -1, pos).reshape(-1)
    lanes = torch.nonzero(cand.reshape(-1))[:, 0]
    out = {
        "found": np.zeros((c * k_max,), bool),
        "start": np.zeros((c * k_max,), np.int64),
        "cfo_bins": np.zeros((c * k_max,), np.int64),
        "sync": np.zeros((c * k_max,), np.int64),
        "symbols": np.zeros((c * k_max, s_pay), np.int64),
        "cfo": np.zeros((c * k_max,), np.float64),
        "time_offset": np.zeros((c * k_max,), np.float64),
        "snr_db": np.zeros((c * k_max,), np.float64),
        "sro_ppm": np.zeros((c * k_max,), np.float64),
        "one_bin": np.zeros((c * k_max,), bool),
    }
    if len(lanes):
        r = frames(xr, xi, config, precision, chan[lanes], start0[lanes], cfo_b[lanes])
        ln = lanes.cpu().numpy()
        fits = r["fits"].cpu().numpy()
        keep = ln[fits]
        out["found"][keep] = True
        for f in ("start", "cfo_bins", "sync", "symbols", "cfo", "snr_db", "sro_ppm", "one_bin"):
            out[f][keep] = r[f].cpu().numpy()[fits]
    return {f: v.reshape(c, k_max, *v.shape[1:]) for f, v in out.items()}


def _at_program(item, config, precision, lanes, out, chunk=2048):
    """Step 4 for ``lanes`` (flat indices) at the program's own start,
    integer CFO and residual CFO: host arrays of the sync word, symbols,
    SNR and the |DFT|^2 [L, 2+S, N] of the sync and payload windows."""
    k_max = config["max_frames"]
    keys = ("sync", "symbols", "snr_db", "spectra")
    parts = {k: [] for k in keys}
    dev = item.xr.device
    for a in range(0, len(lanes), chunk):
        ln = lanes[a:a + chunk]

        def pick(name):
            return torch.as_tensor(out[name].reshape(-1)[ln], device=dev)

        r = demod_at(item.xr, item.xi, config, precision,
                     torch.as_tensor(ln // k_max, device=dev), pick("start"),
                     pick("cfo_bins"), cfo=pick("cfo"))
        for k in keys:
            parts[k].append(r[k].to(torch.float64 if k in ("snr_db", "spectra")
                                    else torch.int64).cpu().numpy())
    if not parts["spectra"]:
        return None
    return {k: np.concatenate(v) for k, v in parts.items()}


def widest_gap(spectra, chosen):
    """The widest relative gap by which a chosen bin's |X|^2 lies below
    the row's best: max over rows of (best - chosen) / best."""
    if spectra.size == 0:
        return 0.0
    best = spectra.max(axis=-1)
    got = np.take_along_axis(spectra, chosen[..., None], axis=-1)[..., 0]
    return float(np.max((best - got) / np.maximum(best, 1e-300)))


def judge(item, out: dict, ref: dict, config: dict, precision: str = "f64") -> dict:
    """The parts of the numbers compared (see :mod:`.check`) for one call
    of the program (``out``, host arrays [C, K, ...]) against the
    reference's ``receive`` (``ref``) of the same block.

    A lane found by both at the same start, integer CFO and timing whose
    preamble peaks the reference finds at more than one bin
    (``one_bin`` False) has no residual CFO independent of the DFT's time
    origin (step 3). There the reference takes the program's residual
    CFO and decides the sync word, symbols and SNR at it (step 4); every
    other lane is held against the reference's own.

    ``lane_mismatch``  (lanes found by either whose found flag, start,
        integer CFO, sync word, timing offset or any symbol differ, lanes
        found by either);
    ``sym_gap``  the widest relative gap by which a payload symbol the
        program decided lies below the best bin of the reference's
        spectrum at the program's own start and CFO;
    ``cfo_err``  per lane found by either, save the lanes above, the
        difference of the residual CFO (bins); ``snr_err``, ``sro_err``
        per lane found by either, that of the SNR (dB) and the clock drift
        (ppm); ``DIFFER`` where the lane's decisions differ;
    ``decode_mismatch``  found frames whose bytes are not the coded
        chain's decode of their own symbols;
    ``origin_lanes``, ``origin_cfo_gap``  (not compared) the share of
        the lanes found by either that take the program's residual CFO,
        and the widest gap there between it and the reference's own."""
    pf, rf = out["found"], ref["found"]
    either = pf | rf
    front = (pf & rf & (out["start"] == ref["start"]) & (out["cfo_bins"] == ref["cfo_bins"])
             & (out["time_offset"] == ref["time_offset"]))
    follow = front & ~ref["one_bin"]
    lanes = np.nonzero(pf.reshape(-1))[0]
    at_prog = _at_program(item, config, precision, lanes, out)
    syms = out["symbols"].reshape(-1, out["symbols"].shape[-1])
    parts = {}
    ref_sync, ref_syms, ref_snr = ref["sync"].copy(), ref["symbols"].copy(), ref["snr_db"].copy()
    if at_prog is None:
        parts["sym_gap"] = 0.0
    else:
        parts["sym_gap"] = widest_gap(at_prog["spectra"][:, 2:], syms[lanes])
        sel = follow.reshape(-1)[lanes]
        fl = lanes[sel]
        ref_sync.reshape(-1)[fl] = at_prog["sync"][sel]
        ref_syms.reshape(-1, ref_syms.shape[-1])[fl] = at_prog["symbols"][sel]
        ref_snr.reshape(-1)[fl] = at_prog["snr_db"][sel]
    same = (front & (out["sync"] == ref_sync)
            & np.all(out["symbols"] == ref_syms, axis=-1))
    parts["lane_mismatch"] = (int(either.sum() - same.sum()), int(either.sum()))
    gap = np.abs(out["cfo"] - ref["cfo"])
    parts["cfo_err"] = np.where(same, gap, DIFFER)[either & ~(same & follow)]
    for name, got, want in (("snr_err", out["snr_db"], ref_snr),
                            ("sro_err", out["sro_ppm"], ref["sro_ppm"])):
        parts[name] = np.where(same, np.abs(got - want), DIFFER)[either]
    decoded = coding.decode_simple(out["symbols"][pf])
    parts["decode_mismatch"] = int(np.sum(np.any(decoded != out["bytes"][pf], axis=-1)))
    parts["origin_lanes"] = (int((same & follow).sum()), int(either.sum()))
    parts["origin_cfo_gap"] = float(gap[same & follow].max()) if (same & follow).any() else 0.0
    return parts


def truth_summary(item, out: dict) -> str:
    """How many of the frames sent were found at their start (within one
    sample) with their bytes: information, not compared."""
    sent = item.starts.size
    ok = 0
    for c in range(item.starts.shape[0]):
        for j in range(item.starts.shape[1]):
            hit = out["found"][c] & (np.abs(out["start"][c] - item.starts[c, j]) <= 1)
            ok += bool(np.any(np.all(out["bytes"][c][hit] == item.payloads[c, j], axis=-1)))
    return f"{ok} of {sent} frames sent found with their bytes"


class System:
    """The reference in the program's place (the control): the same
    calls, computed in ``precision``."""

    def __init__(self, config: dict, device, precision: str = "tf32"):
        self.config, self.precision = config, precision

    def device(self, item):
        r = receive(item.xr, item.xi, self.config, self.precision)
        r["bytes"] = np.zeros((*r["found"].shape, self.config["payload_bytes"]), np.uint8)
        r["bytes"][r["found"]] = coding.decode_simple(r["symbols"][r["found"]])
        return r

    def readout(self, handle) -> dict:
        return handle

    def outputs(self, handle, host: dict) -> dict:
        return host
