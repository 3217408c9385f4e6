"""Batched frame synchronisation and the block receivers — the PyTorch
twin of ``lora_phy_tpu/models/sync.py``.

:func:`frame_sync_scan_planar` runs the two-sided dechirp scan over
``[..., T]`` planes: every symbol window is up- and down-dechirped and
DFT'd, preamble runs are found with the cumulative-max run length

    eq[w]         = bin[w] == bin[w-1]   (within one bin)
    last_false[w] = cummax_w(where(eq, -1, w))
    run[w]        = 1 + w - last_false[w]

and the downchirp section splits timing from integer CFO.
:func:`receive_block_planar` then selects up to ``max_frames`` candidates
per channel, extracts their windows and demodulates every frame, all on
the device; the host only reads the resulting :class:`BlockFrames`.
``pre_acc`` 2..3 is the multipath-robust mode (accumulated-spectrum scan,
common-bin CFO, noncoherent path combining).

Around it: :func:`cad_planar` (channel-activity detection),
:func:`receive_blind_planar` / :func:`blind_frames` (every SF over one
stream) and :func:`receive_wideband_planar` (the polyphase channelizer,
then the block receiver on every channel).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import LoraParams, device_table
from ..ops.channelizer import channelize_planar
from ..ops.chirp import base_downchirp_planar, gen_chirp_np
from ..ops.planar import (_decimation_phase, _preamble_phase_step,
                          _sync_from_symbols, argmax_bins_planar, as_planes,
                          dechirp_planar, dft_mag2_planar, dft_planar,
                          demodulate_spectrum_planar, detect_planar,
                          estimate_preamble_planar,
                          estimate_preamble_robust_planar, estimate_sro_planar,
                          sro_from_powers)
from ..ops.lanes import lane_spectra
from ..ops.scan import scan_peaks, scan_spectra
from ..utils.params import _window_table
from ..utils.profiling import stage_range

QUARTER_DEN = 4  # 2.25 downchirps: 2 full + step/4 samples


def frame_overhead_samples(params: LoraParams, preamble_len: int = 8) -> int:
    """Samples before the payload symbols: preamble + 2 sync + 2.25 down.
    JAX twin: ``lora_phy_tpu/models/stream.py:frame_overhead_samples``."""
    step = params.step
    return (preamble_len + 2) * step + 2 * step + step // QUARTER_DEN


class SyncScan(NamedTuple):
    """Per-window candidate fields, leading dims = input batch dims.

    A window ``w`` with ``valid[w]`` marks the END of a preamble run whose
    frame starts at sample ``start[w]`` with integer CFO ``cfo_bins[w]``.
    """

    valid: torch.Tensor      # [..., W] bool
    start: torch.Tensor      # [..., W] int32 sample index of frame start
    cfo_bins: torch.Tensor   # [..., W] int32
    tau: torch.Tensor        # [..., W] int32 timing offset (samples)
    up_bins: torch.Tensor    # [..., W] int32 raw up-dechirp argmax bins
    dn_bins: torch.Tensor    # [..., W] int32 raw down-dechirp argmax bins


def _signed_bin(b: torch.Tensor, n: int) -> torch.Tensor:
    return torch.where(b > n // 2, b - n, b).to(torch.int32)


def _round_half_even(x: torch.Tensor) -> torch.Tensor:
    # python round() semantics for the k/2 splits (k integer):
    # torch.round is half-to-even, as jnp.round
    return torch.round(x).to(torch.int32)


def _check_pre_acc(pre_acc: int) -> None:
    if not 1 <= pre_acc <= 3:
        raise ValueError(
            "pre_acc must be 1 (off) or 2..3: the SFD pair search and the "
            "3-hypothesis start probe only cover the run-end smear of "
            f"accumulations up to 3 windows (got {pre_acc})")


def _downchirp(params: LoraParams, device):
    """(re, im) base downchirp planes [step] on ``device``."""
    return device_table(base_downchirp_planar, params.sf, params.scale,
                        params.osr, device=device)


def frame_sync_scan_planar(xr: torch.Tensor, xi: torch.Tensor,
                           params: LoraParams, preamble_len: int = 8,
                           min_power_db: float | None = None,
                           pre_acc: int = 1) -> SyncScan:
    """Batched two-sided dechirp frame scan over ``[..., T]`` planes.

    ``min_power_db`` gates candidates on the up-dechirped peak power of
    the run's last preamble window (detector dB convention,
    LoRaDetector.hpp:64: 0 dB = full-scale chirp); without it, silence
    syncs "perfectly".

    ``pre_acc`` 2..3 is the multipath-robust detector: the per-window
    |DFT|² spectra are summed over ``pre_acc`` windows before the argmax
    (a near-equal-power two-ray channel's per-window argmax alternates
    between the paths' bins and never forms a run), the SFD test becomes
    a paired-sum down-vs-up dominance test, and a concentration gate
    (accumulated peak >= 8x the accumulated mean) rejects loud noise."""
    _check_pre_acc(pre_acc)
    n, osr, step = params.n, params.osr, params.step
    nwin = xr.shape[-1] // step
    lead = xr.shape[:-1]
    dev = xr.device
    dr, di = _downchirp(params, dev)
    dph = _decimation_phase(params)

    # up-dechirp (x * down) and down-dechirp (x * conj(down)) of every
    # decimated window, DFT'd: the first-max bins and peaks of both
    # (ops/scan.py: the hand kernel on CUDA), or both whole spectra
    conc_ok = None
    if pre_acc == 1:
        ub, db, up_peak, dn_peak = scan_peaks(xr, xi, dr, di, n, osr, dph)
    else:
        m_up, m_dn = scan_spectra(xr, xi, dr, di, n, osr, dph)   # [..., W, n]
        zrows = torch.zeros(*lead, min(pre_acc, nwin), n, device=dev)

        def lagged(x, j):
            """x shifted j window-rows later (leading zeros), any nwin."""
            return torch.cat([zrows[..., :j, :], x], dim=-2)[..., :nwin, :]

        # causal sliding sum over pre_acc windows as pre_acc-1 shifted
        # adds, as the JAX twin (a cumsum's difference form loses
        # precision on long blocks)
        s_up = m_up
        for j in range(1, pre_acc):
            s_up = s_up + lagged(m_up, j)
        up_max, ub = torch.max(s_up, dim=-1)
        ub = ub.to(torch.int32)
        up_peak = up_max / pre_acc                     # per-window scale
        # loud noise forms long runs under overlapping sums: require a
        # tone-like concentration, accumulated peak >= 8x its mean
        conc_ok = up_peak * pre_acc >= 8.0 * torch.mean(s_up, dim=-1)
        # SFD: paired dn sums; the pair argmax replaces the equality test
        zrow = zrows[..., :1, :]
        dn2 = m_dn + torch.cat([m_dn[..., 1:, :], zrow], dim=-2)
        up2 = m_up + torch.cat([m_up[..., 1:, :], zrow], dim=-2)
        dn_max, db = torch.max(dn2, dim=-1)
        db = db.to(torch.int32)
        dn_peak = dn_max / 2.0
        up_peak_pair = up2.amax(dim=-1) / 2.0

    # --- preamble run lengths; +-1-bin neighbours count as equal (a tone
    # at a half bin flips between two argmax bins on rounding) ----------
    w_idx = torch.arange(nwin, dtype=torch.int32, device=dev)
    false1 = torch.zeros(*lead, 1, dtype=torch.bool, device=dev)
    d_ub = torch.remainder(ub[..., 1:] - ub[..., :-1], n)
    adj = (d_ub == 0) | (d_ub == 1) | (d_ub == n - 1)
    eq = torch.cat([false1, adj], dim=-1)
    last_false = torch.cummax(torch.where(eq, -1, w_idx), dim=-1).values
    run = 1 + w_idx - last_false                      # [..., W]

    need = max(2, preamble_len - 2)
    eq_next = torch.cat([eq[..., 1:], false1], dim=-1)
    is_end = (run >= need) & ~eq_next                 # maximal-run ends

    # --- downchirp section: first c in [end+1, end+5] with db[c]~db[c+1]
    # and down-dechirp dominance at the pair head (silence: 0 > 0 fails);
    # under pre_acc the paired-sum dominance alone
    if pre_acc == 1:
        dn_dom = dn_peak > up_peak
        d_db = torch.remainder(db[..., 1:] - db[..., :-1], n)
        db_adj = (d_db == 0) | (d_db == 1) | (d_db == n - 1)
        db_eq = torch.cat([db_adj & dn_dom[..., :-1], false1], dim=-1)
    else:
        db_eq = torch.cat([(dn_peak > up_peak_pair)[..., :-1], false1], dim=-1)

    def shift_left(a, o):
        pad = torch.zeros(*lead, o, dtype=a.dtype, device=dev)
        return torch.cat([a[..., o:], pad], dim=-1)

    has_dwin = torch.zeros(*lead, nwin, dtype=torch.bool, device=dev)
    bin_dn_raw = torch.zeros_like(db)
    for o in range(5, 0, -1):                         # later offsets lose
        h = shift_left(db_eq, o) & (w_idx + o < nwin - 1)
        bin_dn_raw = torch.where(h, shift_left(db, o), bin_dn_raw)
        has_dwin = has_dwin | h

    bin_up = _signed_bin(ub, n)
    bin_dn = _signed_bin(bin_dn_raw, n)
    # bin n/2 is sign-ambiguous: flip the ambiguous bin(s) where that
    # reduces |bin_up + bin_dn| (minimal-|cfo| prior), first minimum of
    # (u,d), (u,d'), (u',d), (u',d') winning
    half = n // 2
    bu_alt = torch.where(ub == half, bin_up - n, bin_up)
    bd_alt = torch.where(bin_dn_raw == half, bin_dn - n, bin_dn)
    s0 = torch.abs(bin_up + bin_dn)
    s1 = torch.abs(bin_up + bd_alt)
    s2 = torch.abs(bu_alt + bin_dn)
    s3 = torch.abs(bu_alt + bd_alt)
    m = torch.minimum(torch.minimum(s0, s1), torch.minimum(s2, s3))
    pick1 = (s1 == m) & (s0 != m)
    pick2 = (s2 == m) & (s0 != m) & (s1 != m)
    pick3 = (s3 == m) & (s0 != m) & (s1 != m) & (s2 != m)
    bin_up = torch.where(pick2 | pick3, bu_alt, bin_up)
    bin_dn = torch.where(pick1 | pick3, bd_alt, bin_dn)

    # two-sided split; the tau arm divides by the chirp slope ``scale``
    tau = _round_half_even((bin_dn - bin_up) / (2.0 * params.scale)) * osr
    cfo_bins = _round_half_even((bin_dn + bin_up) / 2.0)
    # accumulated bins hold their value ~pre_acc-1 windows past the run end
    # (one host-side constant: no extra device op at pre_acc=1)
    start = (w_idx - (preamble_len - 1 + pre_acc - 1)) * step + tau
    # the run end is fuzzy by one window: keep a nominally negative start
    # whose +step alias is in range (the receiver's probe resolves it)
    valid = is_end & has_dwin & (start + step >= 0)
    if conc_ok is not None:
        valid = valid & conc_ok
    if min_power_db is not None:
        power_db = (10.0 * torch.log10(torch.clamp(up_peak, min=1e-30))
                    - 20.0 * math.log10(n))
        valid = valid & (power_db >= float(np.float32(min_power_db)))
    return SyncScan(valid, start, cfo_bins, tau, ub, db)


# ---------------------------------------------------------------------------
# Block receiver: scan + frame extraction + demod, on the device
# ---------------------------------------------------------------------------

class BlockFrames(NamedTuple):
    """Up to ``max_frames`` demodulated frames per channel from one block.
    Lanes with ``found`` False carry unspecified values."""

    found: torch.Tensor        # [..., K] bool
    start: torch.Tensor        # [..., K] int32 frame-start sample index
    cfo_bins: torch.Tensor     # [..., K] int32 integer CFO
    symbols: torch.Tensor      # [..., K, n_payload] int32 (JAX: uint16)
    sync: torch.Tensor         # [..., K] uint8 recovered sync word
    cfo: torch.Tensor          # [..., K] float32 residual (fractional) CFO
    time_offset: torch.Tensor  # [..., K] float32
    snr_db: torch.Tensor       # [..., K] float32 mean payload peak/noise (dB)
    sro_ppm: torch.Tensor      # [..., K] float32 clock-drift estimate (ppm)


def _kth_valid(valid: torch.Tensor, k_max: int):
    """Positions of the first ``k_max`` True entries along the last axis:
    ``(pos [..., K] int64, found [..., K] bool)``, ``pos`` 0 where not
    found.

    The JAX twin matches the rank cumsum against every k as a
    ``[..., K, W]`` bool array and takes its first True. The rank is
    sorted, so a binary search for each k finds the same position (the
    first window whose rank reaches k is the k-th valid one) with no
    ``[..., K, W]`` temporary."""
    rank = torch.cumsum(valid, dim=-1, dtype=torch.int32)     # [..., W]
    ks = torch.arange(1, k_max + 1, dtype=torch.int32, device=valid.device)
    ks = ks.expand(*valid.shape[:-1], k_max).contiguous()
    pos = torch.searchsorted(rank.contiguous(), ks)           # [..., K]
    found = pos < valid.shape[-1]
    return torch.where(found, pos, 0), found


def _gather_window_rows(rows: torch.Tensor, widx0: torch.Tensor, nwin: int,
                        step: int) -> torch.Tensor:
    """``nwin`` consecutive step-rows per frame: ``rows`` ``[*lead, R,
    step]``, ``widx0`` ``[*lead, K]`` first row per frame ->
    ``[*lead, K, nwin, step]``. The first row is clamped to
    ``[0, R - nwin]`` (the JAX twin's slab gather in CLIP mode); the
    callers' padding keeps found frames inside it."""
    lead = rows.shape[:-2]
    r = rows.shape[-2]
    st = torch.clamp(widx0.to(torch.int64), 0, r - nwin)
    idx = st[..., None] + torch.arange(nwin, device=rows.device)
    flat = rows.reshape(-1, r, step)
    b = flat.shape[0]
    bidx = torch.arange(b, device=rows.device).reshape(b, 1, 1)
    out = flat[bidx, idx.reshape(b, -1, nwin)]               # [B, K, nwin, step]
    return out.reshape(*lead, widx0.shape[-1], nwin, step)


def _gather_shift(xp: torch.Tensor, amt: torch.Tensor, length: int) -> torch.Tensor:
    """``out[..., t] = xp[..., t + amt]`` for ``t < length``, per row
    (``amt`` ``[...]``, ``length + amt <= xp.shape[-1]``): the JAX twin's
    log2-stage barrel shifter as one gather over a zero-padded row."""
    idx = amt.to(torch.int64)[..., None] + torch.arange(length, device=xp.device)
    return torch.gather(xp, -1, idx.expand(*xp.shape[:-1], length))


@functools.lru_cache(maxsize=32)
def _circ_wrap_const(params: LoraParams):
    """``c[t+step]*conj(c[t])`` of the base upchirp lattice — the window
    wrap constant of the circular extraction (host NumPy). The integer
    lattice chirp is anti-periodic over one window, so samples the
    circular select takes from the next grid window carry this constant.
    Returns ``(s0 complex, ok bool)``; ``ok`` is False where the lattice
    is not (anti)periodic, and the circular path must not be used."""
    step = params.step
    up2, _ = gen_chirp_np(params.n, params.osr, 2 * step, 0.0, down=False,
                          ampl=1.0, bw_scale=params.scale)
    s = up2[step:] * np.conj(up2[:step])
    s0 = complex(s[0])
    ok = bool(np.max(np.abs(s - s0)) < 1e-5)
    return s0, ok


def _snr_db(mag2_pay: torch.Tensor, n: int) -> torch.Tensor:
    """Mean payload peak over mean residual power per bin, dB (the
    detector convention, LoRaDetector.hpp:60-64)."""
    return _snr_from_powers(mag2_pay.amax(dim=-1), torch.sum(mag2_pay, dim=-1), n)


def _snr_from_powers(peak: torch.Tensor, total: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`_snr_db` from each payload spectrum's peak and power sum
    ([..., K, S])."""
    noise = (total - peak) / float(n - 1)
    return 10.0 * torch.log10(
        torch.mean(peak, dim=-1)
        / torch.clamp(torch.mean(noise, dim=-1), min=1e-30))


# the record_function ranges of the block receiver's circular path, in
# order: the scan and candidate selection (receive_block_planar), then the
# stages of _receive_block_circular
CIRCULAR_STAGES = ("front", "gather", "probes", "sections", "dechirp", "estimator",
                   "demod", "sro")


def _receive_block_circular(xr, xi, params: LoraParams,
                            n_payload_symbols: int, max_frames: int,
                            preamble_len: int, start, cfo_bins, found,
                            tx_phase_step: float | None = None,
                            with_spectra: bool = False):
    """Shift-free window extraction + demod (osr 1, no window).

    A true symbol window starting ``q`` samples into grid window ``m`` is
    the circular right-shift by ``q`` of the select ``w'[j] = j < q ?
    next[j] : cur[j]``, and with an n-periodic base chirp its |DFT| is the
    aligned spectrum rotated by exactly ``q`` bins. So no sample moves:
    decisions read ``(raw + q_section - cfo_bins) mod n``, and only the
    fractional CFO is derotated, at the true sample index ``(j - q) mod
    n`` (docs/SEMANTICS.md "circular extraction"). One host sync on a
    CUDA device, in the ``estimator`` stage: :func:`..ops.planar.detect_planar`
    copies ``N`` to the device from pageable host memory, which waits for
    the queue to drain (:func:`..utils.profiling.host_sync`).

    The ``demod`` and ``sro`` stages' row spectra come from
    :func:`..ops.lanes.lane_spectra`: on CUDA at N = 256..4096 (and
    without ``with_spectra``) one launch of ``csrc/lanes.cu`` in ``demod``
    serves both, and ``sro`` keeps the fractional-bin arithmetic; else its
    plain twin in ``demod``, and ``sro`` its own DFT.

    While a profiler runs, each stage runs in a ``record_function`` range
    (:func:`stage_range`; nothing otherwise) named after the stages of
    ``tools/profile_block_rx.py``: ``gather``,
    ``probes``, ``sections``, ``dechirp``, ``estimator``, ``demod``,
    ``sro`` (``front`` is the scan in :func:`receive_block_planar`);
    ``tools/torch_profile_block_rx.py`` reads them."""
    n, osr, step = params.n, params.osr, params.step
    assert osr == 1 and step == n
    lead = xr.shape[:-1]
    T = xr.shape[-1]
    dev = xr.device
    pre_len = preamble_len * step
    overhead = frame_overhead_samples(params, preamble_len)
    ov_w, dq = overhead // step, overhead % step      # payload grid offset
    win_full = overhead + n_payload_symbols * step
    nwin_g = win_full // step + 4

    with stage_range("gather"):
        w0 = torch.div(start, step, rounding_mode="floor")   # >= -1 for found
        q = torch.remainder(start, step)                      # [..., K]

        def gather_rows(plane):
            tail = (nwin_g + 2) * step + (-T) % step
            # 2 front windows: the buffer starts one window BEFORE the
            # candidate so the probe can test the -step hypothesis
            rows = F.pad(plane, (2 * step, tail)).reshape(*lead, -1, step)
            return _gather_window_rows(rows, w0 + 1, nwin_g, step)

        g_r, g_i = gather_rows(xr), gather_rows(xi)          # [..., K, nwin_g, step]

    with stage_range("probes"):
        jj = torch.arange(step, dtype=torch.int32, device=dev)
        qq = q[..., None, None]
        # payload grid: the 2.25-downchirp SFD puts the payload dq = step/4
        # past the window grid; the carry bumps its base window by one
        q_p = q + dq
        cp = (q_p >= step).to(torch.int32)
        q_p = q_p - cp * step
        qqp = q_p[..., None, None]

        dr0, di0 = _downchirp(params, dev)
        # wrap constant: samples taken from the NEXT grid window are
        # pre-multiplied by conj(s0) so the dechirped w' is one exact ramp
        s0, _ = _circ_wrap_const(params)
        s0r, s0i = float(np.float32(s0.real)), float(np.float32(s0.imag))

        def circ_select(wr_, wi_, nr_, ni_, m):
            """w'[j] = j<q ? conj(s0)*next[j] : cur[j] (planar)."""
            return (torch.where(m, nr_ * s0r + ni_ * s0i, wr_),
                    torch.where(m, ni_ * s0r - nr_ * s0i, wi_))

        # --- run-end disambiguation: 2 windows x 3 hypotheses; peak
        # magnitudes are rotation- and CFO-invariant
        def _probe(m, down: bool):
            sr, si_ = circ_select(g_r[..., m, :], g_i[..., m, :],
                                  g_r[..., m + 1, :], g_i[..., m + 1, :],
                                  jj < qq[..., 0])
            if down:      # x * conj(down): concentrates downchirps
                ur, ui = sr * dr0 + si_ * di0, si_ * dr0 - sr * di0
            else:         # x * down: concentrates upchirps
                ur, ui = sr * dr0 - si_ * di0, si_ * dr0 + sr * di0
            _, pk = argmax_bins_planar(ur, ui, n, with_peak=True)
            return pk

        def hyp_score(woff):
            return (_probe(woff + preamble_len + 1, down=False)
                    + _probe(woff + preamble_len + 2, down=True))

        # stack order: reported start first, so an exact tie keeps it
        # (torch.argmax returns the first maximum)
        scores = torch.stack([hyp_score(1), hyp_score(0), hyp_score(2)])
        hyp = torch.argmax(scores, dim=0)                  # [..., K] in {0,1,2}
        # window offset of the winning hypothesis: 1 (as reported), 0 (one
        # symbol early) or 2 (one late)
        woff = torch.where(hyp == 1, 0, torch.where(hyp == 2, 2, 1)).to(torch.int32)
        start = start + (woff - 1) * step
        found = found & (start >= 0)      # unrescued negative-start alias
        payload_start = start + overhead
        found = found & (payload_start + n_payload_symbols * step <= T)

    with stage_range("sections"):
        def hyp_pick(gp, base, ln, sel, nsel):
            """gp windows [base+sel .. base+sel+ln) for per-frame sel."""
            out = gp[..., base + nsel - 1: base + nsel - 1 + ln, :]
            for b in range(nsel - 2, -1, -1):
                out = torch.where(sel[..., None, None] == b,
                                  gp[..., base + b: base + b + ln, :], out)
            return out

        def section(base, ln, qsel, sel, nsel):
            """[..., K, ln, step] true windows (rotated by qsel) at window
            ``base + sel``: hypothesis pick, then the circular select against
            the +1-row halo."""
            pr_ = hyp_pick(g_r, base, ln + 1, sel, nsel)
            pi_ = hyp_pick(g_i, base, ln + 1, sel, nsel)
            return circ_select(pr_[..., :-1, :], pi_[..., :-1, :],
                               pr_[..., 1:, :], pi_[..., 1:, :], jj < qsel)

        ps_r, ps_i = section(0, preamble_len + 2, qq, woff, 3)      # pre+sync
        pd_r, pd_i = section(ov_w, n_payload_symbols, qqp, woff + cp, 4)

    with stage_range("dechirp"):
        def dech(a_r, a_i):     # up-dechirp: x * down
            return a_r * dr0 - a_i * di0, a_r * di0 + a_i * dr0

        ps_r, ps_i = dech(ps_r, ps_i)
        pd_r, pd_i = dech(pd_r, pd_i)

    with stage_range("estimator"):
        # residual fractional CFO from the rotated preamble spectra: the tone
        # sits at (cfo_bins - q) mod n
        pps = _phase_step(params, tx_phase_step)
        b0 = torch.remainder(cfo_bins - q, n)
        cfo_resid = estimate_preamble_planar(
            ps_r[..., :preamble_len, :].reshape(*lead, max_frames, pre_len),
            ps_i[..., :preamble_len, :].reshape(*lead, max_frames, pre_len),
            n, osr, phase_step=pps, bin_offset=b0)

    with stage_range("demod"):
        # fractional derotation at the TRUE sample index (j - q) mod n; on
        # the kernel's route one launch serves this stage and the next
        rate = -float(np.float32(2.0 * math.pi)) * cfo_resid / float(n)
        lanes = lane_spectra(ps_r[..., preamble_len:, :], ps_i[..., preamble_len:, :],
                             pd_r, pd_i, rate, q, q_p, params, with_spectra=with_spectra)

        # index correction: raw = s + c - q_section. At chirp slope > 1
        # (BW250/500) the payload grid's quarter-window offset dq rotates
        # every payload tone by dq*(scale-1) more bins; no-op at BW125.
        raw = lanes.raw
        dq_rot = int(round((dq // osr) * (params.scale - 1.0)))
        corr_s = torch.remainder(q - cfo_bins, n)[..., None]
        corr_p = torch.remainder(q_p - cfo_bins + dq_rot, n)[..., None]
        s_idx = torch.arange(2 + n_payload_symbols, dtype=torch.int32, device=dev)
        bins = torch.remainder(raw + torch.where(s_idx < 2, corr_s, corr_p), n)
        sync_word = _sync_from_symbols(bins[..., 0], bins[..., 1], params.sf)
        syms = bins[..., 2:]

    with stage_range("sro"):
        if lanes.sro is None:
            sro_ppm = estimate_sro_planar(
                pd_r.reshape(*lead, max_frames, n_payload_symbols * step),
                pd_i.reshape(*lead, max_frames, n_payload_symbols * step), params)
        else:
            sro_ppm = sro_from_powers(*lanes.sro[1:], params)
        blk = BlockFrames(found, start, cfo_bins, syms, sync_word,
                          cfo_resid, torch.zeros_like(cfo_resid),
                          _snr_from_powers(lanes.peak, lanes.total, n), sro_ppm)
    if not with_spectra:
        return blk
    # payload spectra in TRUE bin order: the power of true bin v sits at
    # rotated index (v - corr_p) mod n
    v = torch.arange(n, dtype=torch.int32, device=dev)
    idx = torch.remainder(v - corr_p, n)[..., None, :].to(torch.int64)
    spectra = torch.gather(lanes.spectra, -1, idx.expand(lanes.spectra.shape))
    return blk, spectra


def _phase_step(params: LoraParams, tx_phase_step: float | None) -> float:
    """The transmitter's inter-symbol preamble phase delta: the override,
    or this framework's own modulator's (:func:`_preamble_phase_step`)."""
    if tx_phase_step is not None:
        return tx_phase_step
    return _preamble_phase_step(params.sf, params.osr, params.scale)


def receive_block_planar(xr: torch.Tensor, xi: torch.Tensor,
                         params: LoraParams, n_payload_symbols: int,
                         max_frames: int = 4, preamble_len: int = 8,
                         min_power_db: float | None = None,
                         pre_acc: int = 1,
                         tx_phase_step: float | None = None,
                         with_spectra: bool = False) -> BlockFrames:
    """Demodulate every frame in a continuous ``[..., T]`` block on the
    device: the two-sided scan, selection of up to ``max_frames``
    candidates per channel, window extraction, the start probe (reported
    start vs one symbol early or late), integer-CFO derotation, dechirp,
    and the preamble-anchored demod of every frame.

    Two extraction paths, as in the JAX twin: the circular path (osr 1,
    no window, an anti-periodic lattice chirp) folds the sub-window shift
    and the integer-CFO derotation into bin arithmetic; the barrel path
    (osr > 1, the Hann window, ``pre_acc`` > 1) gathers window rows,
    shifts them by the sub-window residual and, at osr > 1 and
    ``pre_acc=1``, refines timing below one osr step.

    ``pre_acc`` 2..3 (the multipath-robust mode): the accumulated-spectrum
    scan, the common-bin preamble CFO
    (:func:`..ops.planar.estimate_preamble_robust_planar`) and
    noncoherent path combining: every symbol's |DFT|² is circularly
    cross-correlated with the frame's accumulated preamble spectrum, and
    the decisions are the correlation's argmax.

    ``tx_phase_step`` overrides the transmitter's inter-symbol preamble
    phase delta assumed by the fine-CFO estimator (default: this
    framework's modulator's; ``0.0`` for gr-lora_sdr transmitters).

    Host syncs on a CUDA device (:func:`..utils.profiling.host_sync`):
    one on the circular path, :func:`..ops.planar.detect_planar`'s copy of
    ``N`` in the preamble estimate. On the barrel path, that copy in each
    :func:`..ops.planar.detect_planar` call and, at ``pre_acc=1``, the
    ``t_off == 0`` read of each plane in
    :func:`..ops.planar.demodulate_spectrum_planar`.

    ``with_spectra=True`` also returns the payload spectra ``[..., K,
    n_payload, n]`` in true bin order: |DFT|², or the combining scores
    under ``pre_acc`` > 1 (the statistic the decisions use)."""
    _check_pre_acc(pre_acc)
    n, osr, step = params.n, params.osr, params.step
    lead = xr.shape[:-1]
    T = xr.shape[-1]
    dev = xr.device

    with stage_range("front"):
        scan = frame_sync_scan_planar(xr, xi, params, preamble_len,
                                      min_power_db=min_power_db, pre_acc=pre_acc)
        pos, found = _kth_valid(scan.valid, max_frames)           # [..., K]
        start = torch.gather(scan.start, -1, pos)
        cfo_bins = torch.gather(scan.cfo_bins, -1, pos)

    if (osr == 1 and pre_acc == 1 and _window_table(params) is None
            and _circ_wrap_const(params)[1]):
        return _receive_block_circular(xr, xi, params, n_payload_symbols,
                                       max_frames, preamble_len,
                                       start, cfo_bins, found,
                                       tx_phase_step=tx_phase_step,
                                       with_spectra=with_spectra)

    # --- window extraction: row gather + shift by the sub-window residual;
    # every section and probe window is then a static slice
    pre_len = preamble_len * step
    overhead = frame_overhead_samples(params, preamble_len)
    win_full = overhead + n_payload_symbols * step
    nwin_f = win_full // step + 4      # + shift row, +/- alt windows, margin
    w0 = torch.div(start, step, rounding_mode="floor")   # >= -1 for found
    rsub = torch.remainder(start, step)

    def gather_shift(plane):
        tail = (nwin_f + 2) * step + (-T) % step
        rows = F.pad(plane, (2 * step, tail)).reshape(*lead, -1, step)
        g = _gather_window_rows(rows, w0 + 1, nwin_f, step)
        x = g.reshape(*lead, max_frames, nwin_f * step)
        # x[t] <- x[t + rsub], zero fill: x[t] = stream[start - step + t]
        return _gather_shift(F.pad(x, (0, step)), rsub, x.shape[-1])

    gr_, gi_ = gather_shift(xr), gather_shift(xi)

    # --- run-end disambiguation (start - step / start / start + step):
    # at the TRUE start, window 9 is the second sync UPCHIRP and window 10
    # the first full SFD DOWNCHIRP, so up-dechirping one and
    # down-dechirping the other both concentrate
    dr0, di0 = _downchirp(params, dev)
    dec_phase = _decimation_phase(params)

    def dechirp_pair(sr, si_, down: bool):
        if down:      # x * conj(down): concentrates downchirps
            ur, ui = sr * dr0 + si_ * di0, si_ * dr0 - sr * di0
        else:         # x * down: concentrates upchirps
            ur, ui = sr * dr0 - si_ * di0, si_ * dr0 + sr * di0
        return (ur.reshape(*lead, max_frames, n, osr)[..., dec_phase],
                ui.reshape(*lead, max_frames, n, osr)[..., dec_phase])

    def _probe(a, down: bool):
        ur, ui = dechirp_pair(gr_[..., a:a + step], gi_[..., a:a + step], down)
        _, pk = argmax_bins_planar(ur, ui, n, with_peak=True)
        return pk

    def hyp_score(boff):
        return (_probe(boff + (preamble_len + 1) * step, down=False)
                + _probe(boff + (preamble_len + 2) * step, down=True))

    # buffer offsets {step, 0, 2*step} = time offsets {0, -step, +step};
    # torch.argmax takes the FIRST max, so exact ties keep the reported start
    scores = torch.stack([hyp_score(step), hyp_score(0), hyp_score(2 * step)])
    hyp = torch.argmax(scores, dim=0)                  # [..., K] in {0,1,2}
    woff = torch.where(hyp == 1, 0, torch.where(hyp == 2, 2, 1)).to(torch.int32)
    start = start + (woff - 1) * step
    found = found & (start >= 0)      # unrescued negative-start alias
    boff = (woff * step)[..., None]   # buffer offset of the true start

    def pick(buf, a, ln):
        """buf[a + boff : a + boff + ln] per frame."""
        early = buf[..., a:a + ln]
        mid = buf[..., a + step:a + step + ln]
        late = buf[..., a + 2 * step:a + 2 * step + ln]
        return torch.where(boff == 0, early,
                           torch.where(boff == 2 * step, late, mid))

    # --- sub-osr timing refinement (osr > 1): up-dechirped preamble
    # windows sit -e/osr bins off the integer CFO and the down-dechirped
    # first full SFD window +e/osr; measure e from the two-sided split and
    # micro-shift the gathered buffer by it (not under pre_acc, as JAX)
    if osr > 1 and pre_acc == 1:
        def _disp(a_off, down: bool):
            vr, vi = dechirp_pair(pick(gr_, a_off, step),
                                  pick(gi_, a_off, step), down)
            det = detect_planar(vr, vi, n)
            dd = torch.remainder(det.index - cfo_bins + n // 2, n) - n // 2
            return dd.to(torch.float32) + det.findex

        d_up = 0.5 * (_disp(3 * step, down=False)
                      + _disp(5 * step, down=False))
        d_dn = _disp((preamble_len + 2) * step, down=True)
        # bins-per-sample is scale/osr at chirp slope ``scale``
        e = torch.clamp(torch.round((d_dn - d_up) * (osr / (2.0 * params.scale))),
                        -osr, osr).to(torch.int32)
        start = start + e
        found = found & (start >= 0)
        s_amt = e + osr                                # in [0, 2*osr]

        def _micro_shift(x):                           # x[t] <- x[t + e]
            return _gather_shift(F.pad(x, (osr, osr)), s_amt, x.shape[-1])

        gr_, gi_ = _micro_shift(gr_), _micro_shift(gi_)

    payload_start = start + overhead
    found = found & (payload_start + n_payload_symbols * step <= T)

    def window(buf):
        """preamble ++ sync (2) ++ payload at the winning hypothesis."""
        return torch.cat([pick(buf, 0, pre_len), pick(buf, pre_len, 2 * step),
                          pick(buf, overhead, n_payload_symbols * step)], dim=-1)

    wr = window(gr_)
    wi = window(gi_)
    win_len = wr.shape[-1]

    # integer-CFO derotation, continuous phase over the window
    idx = torch.arange(win_len, dtype=torch.float32, device=dev)
    ph = (-2.0 * math.pi / step) * cfo_bins.to(torch.float32)[..., None] * idx
    c, s = torch.cos(ph), torch.sin(ph)
    dr = wr * c - wi * s
    di = wr * s + wi * c

    yr, yi = dechirp_planar(dr, di, params)
    # residual fractional CFO anchored on the preamble section
    pps = _phase_step(params, tx_phase_step)
    if pre_acc == 1:
        cfo_resid = estimate_preamble_planar(
            yr[..., :pre_len], yi[..., :pre_len], n, osr, phase_step=pps)
        mag2, sync_word, cfo, time_offset = demodulate_spectrum_planar(
            yr[..., pre_len:], yi[..., pre_len:], params,
            known_offsets=(cfo_resid, torch.zeros_like(cfo_resid)),
            dec_phase=dec_phase,
        )
        snr_src = mag2
    else:
        # the common-bin estimate locks to the strongest path; its
        # accumulated spectrum is the combining signature below
        cfo_resid, sig = estimate_preamble_robust_planar(
            yr[..., :pre_len], yi[..., :pre_len], n, osr, phase_step=pps,
            return_acc=True)
        mag2, sync_word, snr_src = _combine_paths(
            yr[..., pre_len:], yi[..., pre_len:], sig, params,
            max_frames, n_payload_symbols, dec_phase)
        cfo = cfo_resid
        time_offset = torch.zeros_like(cfo_resid)
    syms = torch.argmax(mag2, dim=-1).to(torch.int32)
    # clock drift over the CONTIGUOUS payload section only
    sro_ppm = estimate_sro_planar(yr[..., pre_len + 2 * step:],
                                  yi[..., pre_len + 2 * step:], params)
    # the SNR observable keeps the detector's |DFT|² dB convention in
    # both modes (correlation scores carry a signature-dependent scale)
    blk = BlockFrames(found, start, cfo_bins, syms, sync_word,
                      cfo, time_offset, _snr_db(snr_src, n), sro_ppm)
    if with_spectra:
        return blk, mag2
    return blk


def _combine_paths(yr, yi, sig, params: LoraParams, max_frames: int,
                   n_payload_symbols: int, dec_phase: int):
    """Noncoherent path combining of the robust mode: the circular
    cross-correlation of every symbol's |DFT|² with the frame's
    accumulated preamble spectrum ``sig`` ``[..., K, n]``, through three
    DFTs (``IDFT(M * conj(S)).real * n``). Phase-free, so the echo's
    symbol-dependent dechirped phase does not matter, and a fractional
    CFO shifts signature and symbols alike. Returns the payload scores
    ``[..., K, S, n]``, the sync word, and the payload |DFT|² (the SNR
    observable's input)."""
    n, osr = params.n, params.osr
    lead = yr.shape[:-2]
    s_tot = 2 + n_payload_symbols
    vw_r = yr.reshape(*lead, max_frames, s_tot, n, osr)[..., dec_phase]
    vw_i = yi.reshape(*lead, max_frames, s_tot, n, osr)[..., dec_phase]
    m2 = dft_mag2_planar(vw_r, vw_i, n)
    mr, mi = dft_planar(m2, torch.zeros_like(m2), n)
    sr_, si_ = dft_planar(sig, torch.zeros_like(sig), n)
    sr_, si_ = sr_[..., None, :], si_[..., None, :]
    cr_ = mr * sr_ + mi * si_
    ci_ = mi * sr_ - mr * si_
    score, _ = dft_planar(cr_, -ci_, n)
    sb2 = torch.argmax(score[..., :2, :], dim=-1).to(torch.int32)
    sync_word = _sync_from_symbols(sb2[..., 0], sb2[..., 1], params.sf)
    return score[..., 2:, :], sync_word, m2[..., 2:, :]


def block_rows(blk: BlockFrames) -> list[dict]:
    """Rows of a 1-D (single-channel) BlockFrames, one dict per found
    frame; the scalar fields are read to the host in one copy (each is
    exact in float64), ``symbols`` stays a tensor on the block's device."""
    found, start, cfo_bins, cfo, sync, snr_db, sro_ppm = torch.stack(
        [getattr(blk, f).to(torch.float64) for f in
         ("found", "start", "cfo_bins", "cfo", "sync", "snr_db", "sro_ppm")]).cpu().tolist()
    return [{"k": k, "start": int(start[k]), "cfo_bins": int(cfo_bins[k]),
             "cfo": cfo[k], "sync": int(sync[k]), "snr_db": snr_db[k],
             "sro_ppm": sro_ppm[k], "symbols": blk.symbols[k]}
            for k, ok in enumerate(found) if ok]


# ---------------------------------------------------------------------------
# Channel activity, blind SF, wideband
# ---------------------------------------------------------------------------

def cad_planar(xr, xi, params: LoraParams, stride: int = 4,
               threshold_db: float = -30.0, device=None):
    """Channel-activity detection, the SX126x CAD primitive (a short
    listen before talk), batched over ``[..., T]`` planes: every
    ``stride``-th symbol window is up-dechirped and DFT'd, and a buffer
    is *active* when a probed window's peak power clears
    ``threshold_db`` (the detector's dB convention, LoRaDetector.hpp:60-64:
    0 dB = full-scale chirp). Any chirp, at any CFO, concentrates into one
    bin; noise and silence spread. ``stride`` is clamped to the window
    count; a buffer shorter than one symbol gives ``(False, -inf)``.
    Returns ``(active [...] bool, peak_db [...] float32)``; makes no host
    read."""
    xr, xi = as_planes(xr, xi, device)
    n, osr, step = params.n, params.osr, params.step
    nwin = xr.shape[-1] // step
    lead = xr.shape[:-1]
    dev = xr.device
    if nwin < 1:                   # sub-symbol input: nothing to listen to
        return (torch.zeros(lead, dtype=torch.bool, device=dev),
                torch.full(lead, -math.inf, dtype=torch.float32, device=dev))
    stride = min(stride, nwin)     # short buffers: probe what exists
    probe = nwin // stride
    ar = xr[..., : probe * stride * step].reshape(*lead, probe, stride, step)[..., 0, :]
    ai = xi[..., : probe * stride * step].reshape(*lead, probe, stride, step)[..., 0, :]
    dr, di = _downchirp(params, dev)
    ur = (ar * dr - ai * di).reshape(*lead, probe, n, osr)[..., 0]
    ui = (ar * di + ai * dr).reshape(*lead, probe, n, osr)[..., 0]
    _, peak = argmax_bins_planar(ur, ui, n, with_peak=True)
    peak_db = (10.0 * torch.log10(torch.clamp(peak, min=1e-30))
               - 20.0 * math.log10(n))
    best = peak_db.amax(dim=-1)
    return best >= float(np.float32(threshold_db)), best


def receive_blind_planar(xr, xi, base_params: LoraParams,
                         n_payload_symbols: int,
                         sfs=(7, 8, 9, 10, 11, 12), max_frames: int = 4,
                         preamble_len: int = 8,
                         min_power_db: float | None = -30.0,
                         pre_acc: int = 1, device=None) -> dict:
    """Blind spreading-factor receive: the block receiver at every
    candidate SF over the same ``[..., T]`` planes, ``{sf: BlockFrames}``.
    Dechirping with the wrong SF's downchirp spreads a chirp's energy, so
    the preamble run and the SFD test fire only at the true SF (and
    ``min_power_db`` gates the rest). SFs whose symbol period cannot hold
    a preamble and SFD inside ``T`` are left out. ``n_payload_symbols``
    is SF-independent in the simple chain (2 symbols per byte)."""
    xr, xi = as_planes(xr, xi, device)
    out = {}
    t = xr.shape[-1]
    for sf in sfs:
        p = dataclasses.replace(base_params, sf=sf)
        if t // p.step < preamble_len + 4:       # preamble + SFD can't fit
            continue
        out[sf] = receive_block_planar(
            xr, xi, p, n_payload_symbols, max_frames, preamble_len,
            min_power_db, pre_acc=pre_acc)
    return out


def blind_frames(results: dict) -> list[dict]:
    """:func:`receive_blind_planar`'s result as a list of found frames
    sorted by (leading index, start, sf): dicts with ``sf``, ``index``
    (the leading-dim tuple, () for 1-D), ``k``, ``start``, ``sync``,
    ``cfo_bins``, ``snr_db``, ``sro_ppm`` and the ``symbols`` row (a
    tensor on the results' device). One host copy per SF."""
    rows = []
    for sf, blk in results.items():
        fields = ("start", "sync", "cfo_bins", "snr_db", "sro_ppm")
        found = blk.found.reshape(-1)
        flat = torch.nonzero(found).reshape(-1)
        host = torch.stack([getattr(blk, f).reshape(-1)[flat].to(torch.float64)
                            for f in fields] + [flat.to(torch.float64)]).cpu().tolist()
        symbols = blk.symbols.reshape(-1, blk.symbols.shape[-1])
        for j, pos in enumerate(host[-1]):
            pos = int(pos)
            idx = np.unravel_index(pos, tuple(blk.found.shape))
            rows.append({
                "sf": sf,
                "index": tuple(int(i) for i in idx[:-1]),
                "k": int(idx[-1]),
                "start": int(host[0][j]),
                "sync": int(host[1][j]),
                "cfo_bins": int(host[2][j]),
                "snr_db": float(np.float32(host[3][j])),
                "sro_ppm": float(np.float32(host[4][j])),
                "symbols": symbols[pos],
            })
    rows.sort(key=lambda r: (r["index"], r["start"], r["sf"]))
    return rows


def receive_wideband_planar(xr, xi, k: int, params: LoraParams,
                            n_payload_symbols: int, max_frames: int = 4,
                            preamble_len: int = 8, taps_per_branch: int = 7,
                            min_power_db: float | None = -30.0,
                            pre_acc: int = 1,
                            tx_phase_step: float | None = None,
                            with_spectra: bool = False, device=None):
    """The wideband receiver: polyphase-channelize ``[..., T]`` planes
    into ``k`` sub-channels (:func:`..ops.channelizer.channelize_planar`)
    and run the block receiver on every channel in the same call.
    Returns :class:`BlockFrames` with a leading channel axis ``[..., k,
    max_frames]`` (and the spectra with ``with_spectra``).
    ``min_power_db`` (default -30 dB, the Pothos demod examples' thresh)
    keeps quiet channels from syncing on silence or stopband leakage."""
    cr, ci = channelize_planar(xr, xi, k, taps_per_branch, device=device)
    return receive_block_planar(cr, ci, params, n_payload_symbols,
                                max_frames, preamble_len,
                                min_power_db=min_power_db, pre_acc=pre_acc,
                                tx_phase_step=tx_phase_step,
                                with_spectra=with_spectra)
