"""Colliding-frame receive by successive interference cancellation
(SIC) — the PyTorch twin of ``lora_phy_tpu/models/sic.py``.

Nothing upstream survives a collision: the reference demodulates one
frame-aligned buffer (src/phy/LoRaDemod.cpp:31-57), and the stronger of
two overlapping same-SF frames captures the receiver. This receiver peels
frames off in power order:

1. scan and demodulate the block (:func:`.sync.receive_block_planar`),
2. resynthesize the strongest frame with the lattice modulator
   (:func:`.stream.frame_modulate_planar`, bit-exact TX) rotated by its
   estimated total CFO,
3. fit its complex gain by least squares over the frame span and
   subtract,
4. rescan the residual; repeat.

With ``refine`` every peel is followed by a joint re-fit of all frames
peeled so far against the original block (per-frame CFO refinement and a
joint K x K gain solve). The Gram sums and every subtraction stay on the
device; the K x K solve (K <= ``max_iters``) is a host
``np.linalg.solve``, as in the JAX twin, and the host reads what the JAX
twin reads (one copy per read).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import LoraParams
from ..ops.planar import as_planes
from .stream import frame_modulate_planar
from .sync import block_rows, receive_block_planar

_TWO_PI = 6.283185307179586


def _template(symbols: torch.Tensor, cfo_total, sync_word, params: LoraParams,
              preamble_len: int):
    """Unit-amplitude resynthesis of one frame with its recovered sync word
    (``sync_word`` is data, not ``params``), rotated by ``cfo_total`` bins:
    the received frame carries ``exp(+j*2*pi*cfo_total/step * (t - start))``
    (the block receiver derotates by the same convention)."""
    dev = symbols.device
    shift = (params.sf - 4) if params.sf > 4 else 0
    sw = torch.as_tensor(sync_word, dtype=torch.int32, device=dev)
    sync_syms = torch.stack([((sw >> 4) & 0xF) << shift, (sw & 0xF) << shift])
    rr, ri = frame_modulate_planar(symbols.to(torch.int32), params, preamble_len,
                                   amplitude=1.0, sync_symbols=sync_syms)
    cfo = torch.as_tensor(cfo_total, dtype=torch.float32, device=dev)
    ph = (float(np.float32(_TWO_PI / params.step)) * cfo) * torch.arange(
        rr.shape[-1], dtype=torch.float32, device=dev)
    c, s = torch.cos(ph), torch.sin(ph)
    return rr * c - ri * s, rr * s + ri * c


def cancel_frame_planar(xr, xi, symbols, start, cfo_total, params: LoraParams,
                        preamble_len: int = 8, sync_word=None):
    """Subtract one decoded frame from continuous ``[T]`` planes.

    ``symbols``: the frame's hard decisions ``[S]``; ``start``: its first
    preamble sample; ``cfo_total``: integer + residual CFO in bins;
    ``sync_word``: the frame's recovered sync word (None:
    ``params.sync_word``). ``start``, ``cfo_total`` and ``sync_word`` may
    be device scalars: the call makes no host read. Returns ``(xr', xi',
    (gain_re, gain_im), resid_db)`` with ``resid_db`` the power over the
    frame span after the subtraction relative to before (the
    cancellation depth)."""
    t_len = xr.shape[-1]
    dev = xr.device
    if sync_word is None:
        sync_word = params.sync_word
    symbols = torch.as_tensor(symbols, device=dev)
    er, ei = _template(symbols, cfo_total, sync_word, params, preamble_len)
    span = er.shape[-1]
    st = torch.clamp(torch.as_tensor(start, device=dev).to(torch.int64), 0, t_len)
    idx = st + torch.arange(span, device=dev)
    pr, pi_ = F.pad(xr, (0, span)), F.pad(xi, (0, span))
    seg_r, seg_i = pr[idx], pi_[idx]

    den = torch.clamp(torch.sum(er * er + ei * ei), min=1e-30)
    g_re = torch.sum(seg_r * er + seg_i * ei) / den
    g_im = torch.sum(seg_i * er - seg_r * ei) / den
    sub_r = seg_r - (g_re * er - g_im * ei)
    sub_i = seg_i - (g_re * ei + g_im * er)
    before = torch.sum(seg_r * seg_r + seg_i * seg_i)
    after = torch.sum(sub_r * sub_r + sub_i * sub_i)
    resid_db = 10.0 * torch.log10(torch.clamp(after, min=1e-30)
                                  / torch.clamp(before, min=1e-30))
    out_r = pr.index_copy(0, idx, sub_r)[:t_len]
    out_i = pi_.index_copy(0, idx, sub_i)[:t_len]
    return out_r, out_i, (g_re, g_im), resid_db


def _embed_template_planar(symbols, start, cfo_total, sync_word, t_len: int,
                           params: LoraParams, preamble_len: int):
    """Resynthesize one frame (unit amplitude, CFO-rotated) embedded at
    ``start`` into zero ``[t_len]`` planes — the SIC basis vector."""
    er, ei = _template(symbols, cfo_total, sync_word, params, preamble_len)
    span = er.shape[-1]
    st = max(0, min(int(start), t_len))
    pad = (st, t_len + span - st - span)
    return F.pad(er, pad)[:t_len], F.pad(ei, pad)[:t_len]


def _cfo_slope_planar(yr, yi, er, ei, step: int) -> torch.Tensor:
    """Residual CFO of ``y`` against the unit template ``e`` (both [T]
    planes, the template zero outside its frame): the phase slope of the
    per-window inner products ``p_w = sum_win y*conj(e)``, in the cancel
    convention's bins (2*pi*cfo of phase per ``step`` samples).
    Magnitude-weighted, so windows where the template is zero add
    nothing."""
    nwin = yr.shape[-1] // step
    cr = (yr * er + yi * ei)[..., : nwin * step].reshape(nwin, step)
    ci = (yi * er - yr * ei)[..., : nwin * step].reshape(nwin, step)
    pr, pi_ = torch.sum(cr, -1), torch.sum(ci, -1)         # [W] complex
    dr = pr[1:] * pr[:-1] + pi_[1:] * pi_[:-1]
    di = pi_[1:] * pr[:-1] - pr[1:] * pi_[:-1]
    return torch.atan2(torch.sum(di), torch.sum(dr)) / float(np.float32(_TWO_PI))


def refine_sic_planar(xr0, xi0, frames: list, params: LoraParams,
                      preamble_len: int = 8, n_iters: int = 3,
                      n_payload_symbols: int | None = None,
                      min_power_db: float | None = -30.0, device=None):
    """Joint re-fit of all peeled frames against the ORIGINAL block:
    per-frame CFO refinement and joint complex gains, iterated.

    The sequential peel estimates each frame while the others are still
    in the stream: the least-squares gain is biased a few percent
    (shifted chirps are only near-orthogonal) and the preamble CFO by a
    few 1e-3 bins, which integrates to about a radian of drift across the
    frame and caps cancellation near -10 dB. Each round solves the K x K
    normal equations ``(E^H E) g = E^H y0`` (device Gram sums, host
    solve), re-estimates every frame's CFO from its interference-
    cancelled view ``y0 - sum_{j != k} g_j e_j`` and rebuilds the
    templates; it stops early when no frame's CFO moved by more than
    1e-6 bins. With ``n_payload_symbols`` a decision refresh follows:
    every frame is demodulated again from its interference-cancelled view
    and the rounds rerun if a decision changed.

    Updates each frame dict's ``gain`` / ``cfo`` (and decisions, on
    refresh) in place, adds ``cancel_resid_db_joint``, and returns the
    jointly cancelled ``(xr', xi')`` planes."""
    yr, yi = as_planes(xr0, xi0, device)
    k = len(frames)
    if k == 0:
        return yr, yi
    t_len = yr.shape[-1]
    dev = yr.device

    def templates():
        pairs = [_embed_template_planar(
            torch.as_tensor(f["symbols"], device=dev), f["start"],
            float(np.float32(f["cfo_bins"] + f["cfo"])), f["sync"], t_len,
            params, preamble_len) for f in frames]
        return (torch.stack([p[0] for p in pairs]),
                torch.stack([p[1] for p in pairs]))        # [K, T]

    def solve(er_all, ei_all):
        ar = er_all @ er_all.T + ei_all @ ei_all.T         # Re(E^H E)
        ai = er_all @ ei_all.T - ei_all @ er_all.T         # Im(E^H E)
        br = er_all @ yr + ei_all @ yi                     # Re(E^H y)
        bi = er_all @ yi - ei_all @ yr                     # Im(E^H y)
        host = torch.cat([ar.reshape(-1), ai.reshape(-1), br, bi]).cpu().numpy()
        a = host[: k * k].reshape(k, k) + 1j * host[k * k: 2 * k * k].reshape(k, k)
        b = host[2 * k * k: 2 * k * k + k] + 1j * host[2 * k * k + k:]
        return np.linalg.solve(a + 1e-9 * np.trace(a).real / k * np.eye(k), b)

    def gains(g):
        return (torch.from_numpy(g.real.astype(np.float32)).to(dev)[:, None],
                torch.from_numpy(g.imag.astype(np.float32)).to(dev)[:, None])

    def subtract(er_all, ei_all, g_re, g_im):
        return (yr - torch.sum(g_re * er_all - g_im * ei_all, dim=0),
                yi - torch.sum(g_re * ei_all + g_im * er_all, dim=0))

    def own_view(res_r, res_i, er_all, ei_all, g_re, g_im, idx):
        """The residual with frame ``idx``'s own fitted copy added back."""
        return (res_r + g_re[idx, 0] * er_all[idx] - g_im[idx, 0] * ei_all[idx],
                res_i + g_re[idx, 0] * ei_all[idx] + g_im[idx, 0] * er_all[idx])

    def gains_cfo_rounds(er_all, ei_all):
        g = None
        for it in range(n_iters):
            g = solve(er_all, ei_all)
            g_re, g_im = gains(g)
            if it == n_iters - 1:
                break
            res_r, res_i = subtract(er_all, ei_all, g_re, g_im)
            slopes = torch.stack([
                _cfo_slope_planar(*own_view(res_r, res_i, er_all, ei_all,
                                            g_re, g_im, idx),
                                  er_all[idx], ei_all[idx], params.step)
                for idx in range(k)]).cpu().tolist()
            changed = False
            for f, dcfo in zip(frames, slopes):
                if abs(dcfo) > 1e-6:
                    f["cfo"] = float(f["cfo"] + dcfo)
                    changed = True
            if not changed:
                break
            er_all, ei_all = templates()
        return g, er_all, ei_all

    er_all, ei_all = templates()
    g, er_all, ei_all = gains_cfo_rounds(er_all, ei_all)

    # decision refresh: demodulate every frame again from its
    # interference-cancelled view (the first decisions were made with only
    # the stronger frames peeled)
    if n_payload_symbols is not None:
        g_re, g_im = gains(g)
        res_r, res_i = subtract(er_all, ei_all, g_re, g_im)
        changed = False
        for idx, f in enumerate(frames):
            yk_r, yk_i = own_view(res_r, res_i, er_all, ei_all, g_re, g_im, idx)
            blk = receive_block_planar(yk_r, yk_i, params, n_payload_symbols,
                                       max_frames=2, preamble_len=preamble_len,
                                       min_power_db=min_power_db)
            rows = [r for r in block_rows(blk)
                    if abs(r["start"] - f["start"]) <= params.step]
            if not rows:
                continue
            row = min(rows, key=lambda r: abs(r["start"] - f["start"]))
            if (row["start"] != f["start"] or not torch.equal(
                    row["symbols"], torch.as_tensor(f["symbols"], device=dev))):
                for key in ("start", "symbols", "sync", "cfo_bins", "cfo",
                            "snr_db"):
                    f[key] = row[key]
                changed = True
        if changed:
            er_all, ei_all = templates()
            g, er_all, ei_all = gains_cfo_rounds(er_all, ei_all)

    g_re, g_im = gains(g)
    out_r, out_i = subtract(er_all, ei_all, g_re, g_im)
    # power from each frame's start to the block end, before and after,
    # for every frame in one host copy
    starts = torch.tensor([max(0, min(int(f["start"]), t_len - 1)) for f in frames],
                          device=dev)
    tail = torch.arange(t_len, device=dev)[None, :] >= starts[:, None]   # [K, T]
    p0 = torch.where(tail, (yr * yr + yi * yi)[None, :], 0.0).sum(-1)
    p1 = torch.where(tail, (out_r * out_r + out_i * out_i)[None, :], 0.0).sum(-1)
    before, after = torch.stack([p0, p1]).cpu().tolist()
    for idx, f in enumerate(frames):
        f["gain"] = (float(g[idx].real), float(g[idx].imag))
        f["cancel_resid_db_joint"] = 10.0 * np.log10(
            max(after[idx], 1e-30) / max(before[idx], 1e-30))
    return out_r, out_i


def receive_sic_planar(xr, xi, params: LoraParams, n_payload_symbols: int,
                       max_frames: int = 4, preamble_len: int = 8,
                       min_power_db: float | None = -30.0,
                       max_iters: int = 4, pre_acc: int = 1,
                       refine: bool = True, device=None):
    """Iterative collision receiver over single-channel ``[T]`` planes.

    Each pass demodulates the block, records the strongest frame not yet
    peeled (more than a symbol from every peeled start), cancels it and
    rescans; it stops when a pass finds nothing new or after
    ``max_iters`` frames. Returns ``(frames, (xr', xi'))``: ``frames`` a
    list of dicts (``start``, ``symbols`` (a tensor on the planes'
    device), ``sync``, ``cfo_bins``, ``cfo``, ``snr_db``, ``sro_ppm``,
    ``sic_pass``, ``cancel_resid_db``, ``gain``) sorted by start, and the
    final residual planes.

    ``refine=True`` runs :func:`refine_sic_planar` over all frames peeled
    so far after every peel (the jointly cancelled residual is what the
    next pass scans) and a last round with the decision refresh."""
    xr, xi = as_planes(xr, xi, device)
    xr0, xi0 = xr, xi
    decoded: list[dict] = []
    guard = params.step  # a residual re-syncs within a symbol of a peel
    for it in range(max_iters):
        blk = receive_block_planar(xr, xi, params, n_payload_symbols,
                                   max_frames, preamble_len,
                                   min_power_db=min_power_db, pre_acc=pre_acc)
        rows = [r for r in block_rows(blk)
                if all(abs(r["start"] - d["start"]) > guard for d in decoded)]
        if not rows:
            break
        best = max(rows, key=lambda r: r["snr_db"])
        best["sic_pass"] = it
        decoded.append(best)
        if refine:
            xr, xi = refine_sic_planar(xr0, xi0, decoded, params, preamble_len)
            best["cancel_resid_db"] = best["cancel_resid_db_joint"]
        else:
            xr, xi, (g_re, g_im), resid_db = cancel_frame_planar(
                xr, xi, best["symbols"], best["start"],
                float(np.float32(best["cfo_bins"] + best["cfo"])),
                params, preamble_len, sync_word=best["sync"])
            resid_db, g_re, g_im = torch.stack([resid_db, g_re, g_im]).cpu().tolist()
            best["cancel_resid_db"] = resid_db
            best["gain"] = (g_re, g_im)
    decoded.sort(key=lambda r: r["start"])
    if refine and decoded:
        # a last round with the decision refresh: the frames decoded first
        # saw the dirtiest stream
        xr, xi = refine_sic_planar(xr0, xi0, decoded, params, preamble_len,
                                   n_payload_symbols=n_payload_symbols,
                                   min_power_db=min_power_db)
        decoded.sort(key=lambda r: r["start"])
    return decoded, (xr, xi)
