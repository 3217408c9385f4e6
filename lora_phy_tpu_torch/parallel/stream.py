"""Time-sharded continuous-stream demodulation with overlap-save halos —
the PyTorch twin of ``lora_phy_tpu/parallel/stream.py``.

* The IQ stream is split into consecutive time blocks along the mesh's
  ``time`` axis, channels along ``channel`` (:mod:`.mesh`).
* The timing-offset shift reads up to one symbol across block seams, so
  each shard receives a one-symbol overlap-save halo from both neighbours
  (:func:`.mesh.ppermute`), zeros at the stream's two ends.
* The 2-symbol CFO/TO estimate is taken where the frame head lives (time
  shard 0) and broadcast along the time axis (:func:`.mesh.psum_first`).
* The derotation needs the GLOBAL symbol index only for the guard of the
  timing shift (src/phy/LoRaDemod.cpp:141-149), which each shard rebuilds
  from its time index.

:func:`receive_stream_block_planar` runs the frame-sync scan and the block
receiver (:func:`..models.sync.receive_block_planar`) on every shard over
its block plus a frame-length right halo, so frames at any stream position,
straddling seams included, are found once, at their global starts.

Each entry point runs one per-shard body through :func:`.mesh.run_shards`;
the collectives are tensor moves and reductions across the grid. Shards
launch on their own devices in turn: on one card a body's launches are
multiplied by the number of shards (the block receiver's ~600 per call
become ~600 x T). Results are joined on the mesh's home device (shard (0,
0)'s); in a multi-process mesh they cover this process's time range.

Global sample indices are int64 here (the JAX twin's are int32: one
channel's headline stream of 69.2 M samples fits either way).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch

from .. import LoraParams, device_of
from ..models.modem import _round_half_away, _sync_from_symbols, _window_tensor
from ..models.stream import frame_overhead_samples
from ..models.sync import BlockFrames, receive_block_planar
from ..ops.planar import (_TWO_PI_F32, _estimate_planar, _max_abs,
                          _rotated_windows_planar, argmax_bins_planar,
                          split_complex)
from . import mesh as meshlib
from .mesh import TIME_AXIS, Mesh, pmax, ppermute, psum_first


# ---------------------------------------------------------------------------
# The time-sharded streaming demodulator
# ---------------------------------------------------------------------------

def _stream_demod_local_planar(shard, xr, xi, params: LoraParams,
                               comm: bool = True):
    """Per-shard body of the streaming demod (the JAX twin's
    ``_stream_demod_core`` with its planar closures) over the local
    ``[c, L]`` planes. Yields its collectives: the per-channel amplitude
    pmax, the two halos, the broadcast of shard 0's estimate and sync.

    The amplitude scale is folded into the estimate's head and the
    derotation factors, as on the port's single-device path
    (:func:`..ops.planar._demod_stage_planar`); the halos travel unscaled
    (every shard of a row has the same scale).

    ``comm=False`` is a MEASUREMENT-ONLY knob (runners/bench_scaling.py's
    collective-vs-compute split): every collective is replaced by its
    local stub, so the identical per-shard compute runs with zero
    communication. Results are wrong at shard seams — never decode with it.
    """
    n, osr, step = params.n, params.osr, params.step
    halo = step
    L = xr.shape[-1]
    s_per_block = L // step
    dev = xr.device

    # --- global per-channel amplitude normalisation (LoRaDemod.cpp:59-77)
    max_amp = torch.maximum(_max_abs(xr), _max_abs(xi))
    if comm:
        max_amp = yield pmax(max_amp)
    scale = torch.where(max_amp > 1.0, 1.0 / max_amp, torch.ones_like(max_amp))

    # --- overlap-save halos, both planes in one message each way
    if comm:
        right = yield ppermute(torch.stack([xr[..., :halo], xi[..., :halo]]), -1)
        left = yield ppermute(torch.stack([xr[..., -halo:], xi[..., -halo:]]), 1)
    else:
        right = left = torch.zeros(2, *xr.shape[:-1], halo, device=dev)

    # --- frame-head CFO/TO estimate, broadcast from time shard 0
    window = _window_tensor(params, dev)
    cfo, time_offset = _estimate_planar(xr[..., :2 * step] * scale[..., None],
                                        xi[..., :2 * step] * scale[..., None],
                                        n, osr, window)
    if comm:
        cfo, time_offset = (yield psum_first(torch.stack([cfo, time_offset])))
    t_off = _round_half_away(time_offset).to(torch.int32)
    rate = -_TWO_PI_F32 * cfo / float(n)

    # --- shifted symbol windows from the extended (haloed) block: the
    # shift view is ext[off : off + L] with off clipped to [0, 2*halo]
    # (the twin's dynamic_slice), one host read of the per-channel offsets
    g_base = (shard.t_idx * L
              + torch.arange(s_per_block, dtype=torch.int64, device=dev) * step)
    t = t_off.to(torch.int64)[..., None]
    total = shard.t_size * L                       # global stream length
    use_shift = (((t > 0) & (g_base + t + step <= total))
                 | ((t < 0) & (-t <= g_base)))[..., None]          # [c, S, 1]
    offs = torch.clamp(t_off + halo, 0, 2 * halo).tolist()

    def windows(x, lo, hi):
        ext = torch.cat([lo, x, hi], dim=-1)
        out = torch.empty(*x.shape[:-1], s_per_block, n, device=dev)
        for c, o in enumerate(offs):
            shifted = ext[c, o:o + L].reshape(s_per_block, n, osr)[..., 0]
            base = x[c, :s_per_block * step].reshape(s_per_block, n, osr)[..., 0]
            torch.where(use_shift[c], shifted, base, out=out[c])
        return out

    yr = windows(xr, left[0], right[0])
    yi = windows(xi, left[1], right[1])
    fr, fi = _rotated_windows_planar(yr, yi, rate, t_off, scale, params)
    idx = argmax_bins_planar(fr, fi, n)
    sync = _sync_from_symbols(idx[..., 0], idx[..., 1], params.sf)
    if comm:
        sync = yield psum_first(sync)
    return idx, sync, cfo, time_offset


def demodulate_stream_planar(xr, xi, params: LoraParams, mesh: Mesh,
                             comm: bool = True):
    """Demodulate a dechirped continuous stream given as (re, im) float32
    planes ``[channels, T]`` sharded over ``(channel, time)`` (``T``
    divisible by ``n_time * step``; a tensor, an array or a
    :class:`.mesh.ShardedTensor` from :func:`.mesh.device_put`). The first
    two symbols of the stream are the sync word (reference contract).

    Returns ``(symbols [channels, T/step] int32, sync [channels], cfo,
    time_offset)`` on the mesh's home device (the JAX twin's symbols are
    uint16). ``comm=False`` stubs every collective for the scaling
    harness (measurement only — wrong at shard seams)."""
    sh = meshlib.stream_sharding(mesh)
    grid = meshlib.run_shards(mesh, _stream_demod_local_planar,
                              meshlib.blocks_of(xr, sh), meshlib.blocks_of(xi, sh),
                              params=params, comm=comm)
    home = mesh.home
    syms = meshlib.join([[r[0] for r in row] for row in grid], -1, home)
    sync, cfo, time_offset = (
        meshlib.join([[r[i] for r in row] for row in grid], None, home)
        for i in (1, 2, 3))
    return syms, sync, cfo, time_offset


def demodulate_stream(samples, params: LoraParams, mesh: Mesh,
                      backend: str = "auto"):
    """Complex64 twin of :func:`demodulate_stream_planar` (``samples``
    ``[channels, T]``): a wrapper over the planar body, as every complex
    demodulator of the port. ``backend`` is checked as in
    :func:`..models.modem.demodulate` (``dft`` is refused)."""
    from ..models.modem import _check_backend

    _check_backend(backend)
    if not isinstance(samples, torch.Tensor):
        samples = torch.from_numpy(np.asarray(samples, np.complex64))
    xr, xi = split_complex(samples)
    return demodulate_stream_planar(xr, xi, params, mesh)


# ---------------------------------------------------------------------------
# Time-sharded frame-SYNC scan + block receive
# ---------------------------------------------------------------------------

def _receive_block_local(shard, xr, xi, params: LoraParams,
                         n_payload_symbols: int, max_frames: int,
                         preamble_len: int, min_power_db, pre_acc: int,
                         halo_steps: int, tx_phase_step=None,
                         with_spectra: bool = False):
    """Per-shard body: frame scan + demod over the local block extended by
    a frame-length RIGHT halo.

    A frame is detected from its preamble (which begins at the frame
    start), so a frame starting inside my block — even at its last sample
    — is fully visible in ``local ++ right-halo``; no left halo is needed.
    Ownership is by frame START: shard ``t`` claims frames with resolved
    start in ``[0, L)`` local samples, so every frame is reported once."""
    step = params.step
    L = xr.shape[-1]
    halo = halo_steps * step
    right = yield ppermute(torch.stack([xr[..., :halo], xi[..., :halo]]), -1)
    res = receive_block_planar(
        torch.cat([xr, right[0]], dim=-1), torch.cat([xi, right[1]], dim=-1),
        params, n_payload_symbols, max_frames, preamble_len,
        min_power_db=min_power_db, pre_acc=pre_acc,
        tx_phase_step=tx_phase_step, with_spectra=with_spectra)
    blk, spectra = res if with_spectra else (res, None)
    # claim: start in [0, L) — receive_block_planar already enforces
    # start >= 0 (negative-start aliases the left neighbour owns)
    found = blk.found & (blk.start < L)
    g_start = blk.start.to(torch.int64) + shard.t_idx * L
    # the per-shard fit check ran against L + halo, but the last shard's
    # halo is zero fill past the global stream end: re-check the fit
    # against the true global length, or a frame truncated by the end of
    # the stream is reported found with argmax-over-zeros symbols
    g_end = (g_start + frame_overhead_samples(params, preamble_len)
             + n_payload_symbols * step)
    found = found & (g_end <= shard.t_size * L)
    return blk._replace(found=found, start=g_start), spectra


def _halo_steps(params: LoraParams, n_payload_symbols: int,
                preamble_len: int) -> int:
    """Right-halo length (in symbol steps) the sharded scan needs: one
    full frame plus the block receiver's probe margin."""
    win_full = (frame_overhead_samples(params, preamble_len)
                + n_payload_symbols * params.step)
    return -(-win_full // params.step) + 4


def _stream_length(x) -> int:
    if isinstance(x, meshlib.ShardedTensor):
        mesh = x.sharding.mesh
        return x.blocks[0][0].shape[-1] * mesh.n_time
    return x.shape[-1]


def receive_stream_block_planar(xr, xi, params: LoraParams,
                                n_payload_symbols: int, mesh: Mesh,
                                max_frames: int = 4,
                                preamble_len: int = 8,
                                min_power_db: float | None = None,
                                pre_acc: int = 1,
                                tx_phase_step: float | None = None,
                                with_spectra: bool = False):
    """Mesh-sharded raw-stream receiver: the frame-sync scan, candidate
    selection, SFD probe and demod of :func:`..models.sync.
    receive_block_planar` on every shard of ``(channel, time)``.

    Frames may start anywhere, straddling time-shard seams included: each
    shard scans its block plus a frame-length halo from its right
    neighbour and claims exactly the frames that START inside its block.
    Returns :class:`~..models.sync.BlockFrames` with ``start`` in GLOBAL
    stream samples (int64) and ``max_frames * n_time`` candidate slots per
    channel (per-shard slots in time-shard order; ``max_frames`` is the
    per-shard cap). ``with_spectra=True`` returns ``(BlockFrames,
    spectra [channels, n_time * K, n_payload, n])``; ``tx_phase_step`` and
    ``pre_acc`` pass through to the per-shard receiver."""
    step = params.step
    # the gathered candidate buffer reaches win//step + 4 windows past the
    # frame start (receive_block_planar's margin for the shift row and the
    # +/-step probe hypotheses)
    halo_steps = _halo_steps(params, n_payload_symbols, preamble_len)
    t_size = mesh.shape[TIME_AXIS]
    block = _stream_length(xr) // t_size
    if halo_steps * step > block:
        raise ValueError(
            f"time-shard block of {block} samples is shorter than one "
            f"frame + margin ({halo_steps * step}); use fewer time shards "
            "or longer blocks (the halo comes from the immediate "
            "neighbour only)")
    sh = meshlib.stream_sharding(mesh)
    grid = meshlib.run_shards(
        mesh, _receive_block_local, meshlib.blocks_of(xr, sh),
        meshlib.blocks_of(xi, sh), params=params,
        n_payload_symbols=n_payload_symbols, max_frames=max_frames,
        preamble_len=preamble_len, min_power_db=min_power_db,
        pre_acc=pre_acc, halo_steps=halo_steps, tx_phase_step=tx_phase_step,
        with_spectra=with_spectra)
    home = mesh.home
    blk = BlockFrames(*(meshlib.join([[r[0][i] for r in row] for row in grid], 1, home)
                        for i in range(len(BlockFrames._fields))))
    if with_spectra:
        return blk, meshlib.join([[r[1] for r in row] for row in grid], 1, home)
    return blk


def receive_blind_stream_planar(xr, xi, base_params: LoraParams,
                                n_payload_symbols: int, mesh: Mesh,
                                sfs=(7, 8, 9, 10, 11, 12),
                                max_frames: int = 4,
                                preamble_len: int = 8,
                                min_power_db: float | None = -30.0,
                                pre_acc: int = 1) -> dict:
    """Mesh twin of :func:`..models.sync.receive_blind_planar`: the blind
    spreading-factor fan-out with each per-SF scan run by
    :func:`receive_stream_block_planar`. Returns ``{sf: BlockFrames}``
    with GLOBAL starts (feed to ``models.sync.blind_frames`` unchanged).
    SFs whose preamble cannot fit the stream, whose frame + margin halo
    exceeds one time-shard block, or whose symbol does not divide the
    block are omitted AND reported through ``warnings.warn``, so 'not
    scanned' differs from 'scanned, no frames'."""
    total = _stream_length(xr)
    block = total // mesh.shape[TIME_AXIS]
    out = {}
    for sf in sfs:
        p = dataclasses.replace(base_params, sf=sf)
        skip = None
        if total // p.step < preamble_len + 4:
            skip = "stream shorter than preamble+margin"
        elif _halo_steps(p, n_payload_symbols, preamble_len) * p.step > block:
            skip = "frame + margin halo exceeds one time-shard block"
        elif block % p.step:
            skip = "time-shard seam does not land on a symbol boundary"
        if skip is not None:
            warnings.warn(
                f"blind mesh scan skipped SF{sf}: {skip} (block={block}, "
                f"step={p.step}); use fewer time shards or a longer stream",
                stacklevel=2)
            continue
        out[sf] = receive_stream_block_planar(
            xr, xi, p, n_payload_symbols, mesh, max_frames, preamble_len,
            min_power_db, pre_acc=pre_acc)
    return out


# ---------------------------------------------------------------------------
# Checkpoint/resume for the sharded streaming receiver
# ---------------------------------------------------------------------------

class MeshStreamState(NamedTuple):
    """Carry state of :class:`MeshStreamDemodulator`: the stream tail (on
    the device), the absolute index of its first sample, the EXACT starts
    of recently emitted frames (per channel, -1 padded: a frame an earlier
    ``max_frames`` cap dropped sits before later emitted ones, and the
    tail re-scan must still emit it) and the frame count."""

    tail_re: torch.Tensor      # [channels, keep] carried stream tail
    tail_im: torch.Tensor      # [channels, keep]
    consumed: int              # absolute sample index of the tail start
    emitted_start: np.ndarray  # [channels, R] int64 recent starts, -1 pad
    n_frames: int              # frames emitted so far (observability)


_ROW_FIELDS = ("found", "start", "cfo_bins", "sync", "cfo", "snr_db", "sro_ppm")


class MeshStreamDemodulator:
    """Block-wise continuous-stream frame receiver on a ``(channel, time)``
    mesh: every fed block runs ONE :func:`receive_stream_block_planar`
    (sharded scan + seam halos + demod), and the receiver carries a
    fixed-length stream tail plus per-channel dedupe marks between blocks.

    The tail is one frame + probe margin long (rounded up to the mesh's
    time granularity), so a frame straddling a block boundary is seen
    whole in the next call; frames re-found inside the tail are deduped by
    their absolute start. ``max_frames`` is the per-TIME-SHARD candidate
    cap; a channel with more frames in one shard block drops the excess.
    """

    def __init__(self, params: LoraParams, n_payload_symbols: int,
                 mesh: Mesh, max_frames: int = 4, preamble_len: int = 8,
                 min_power_db: float | None = -30.0, pre_acc: int = 1,
                 tx_phase_step: float | None = None,
                 with_spectra: bool = False):
        self.params = params
        self.n_payload_symbols = n_payload_symbols
        self.mesh = mesh
        self.max_frames = max_frames
        self.preamble_len = preamble_len
        self.min_power_db = min_power_db
        self.pre_acc = pre_acc
        self.tx_phase_step = tx_phase_step
        self.with_spectra = with_spectra   # frames carry a "spectra" row
        self.t_size = mesh.shape[TIME_AXIS]
        self.unit = self.t_size * params.step    # fed-block granularity
        self.halo = _halo_steps(params, n_payload_symbols,
                                preamble_len) * params.step
        self.keep = -(-self.halo // self.unit) * self.unit
        self.frame_len = (frame_overhead_samples(params, preamble_len)
                          + n_payload_symbols * params.step)
        # dedupe window: only frames STARTING inside the carried tail can
        # be re-found next call; the preamble alone bounds their packing
        self.n_recent = self.keep // (preamble_len * params.step) + 2

    def init_state(self, n_channels: int) -> MeshStreamState:
        z = torch.zeros(n_channels, self.keep, device=self.mesh.home)
        return MeshStreamState(
            z, z.clone(), -self.keep,
            np.full((n_channels, self.n_recent), -1, np.int64), 0)

    def process(self, state: MeshStreamState, block_re, block_im):
        """Feed one ``[channels, B]`` block (``B`` a multiple of ``t_size *
        step``). Returns ``(new_state, frames)``: dicts ``{channel, start,
        symbols, sync, cfo_bins, cfo, snr_db, sro_ppm}`` (plus ``spectra``)
        with ``start`` in ABSOLUTE samples, in (channel, start) order;
        ``symbols`` and ``spectra`` are rows on the mesh's home device, the
        rest host values read in one copy."""
        dev = state.tail_re.device
        block_re = torch.as_tensor(block_re, dtype=torch.float32, device=dev)
        block_im = torch.as_tensor(block_im, dtype=torch.float32, device=dev)
        b = block_re.shape[-1]
        if b % self.unit:
            raise ValueError(
                f"block length {b} must be a multiple of time_shards * "
                f"step = {self.unit}")
        if (self.keep + b) // self.t_size < self.halo:
            raise ValueError(
                f"block of {b} samples gives per-shard blocks of "
                f"{(self.keep + b) // self.t_size} < frame+margin halo "
                f"{self.halo}; feed at least "
                f"{self.halo * self.t_size - self.keep} samples per block")
        buf_r = torch.cat([state.tail_re, block_re], dim=-1)
        buf_i = torch.cat([state.tail_im, block_im], dim=-1)
        res = receive_stream_block_planar(
            buf_r, buf_i, self.params, self.n_payload_symbols, self.mesh,
            self.max_frames, self.preamble_len, self.min_power_db,
            pre_acc=self.pre_acc, tx_phase_step=self.tx_phase_step,
            with_spectra=self.with_spectra)
        blk, spec = res if self.with_spectra else (res, None)
        host = torch.stack([getattr(blk, f).to(torch.float64)
                            for f in _ROW_FIELDS]).cpu().numpy()
        found, starts = host[0] != 0, host[1].astype(np.int64)
        frames = []
        n = state.n_frames
        new_consumed = state.consumed + buf_r.shape[-1] - self.keep
        new_recent = np.full_like(state.emitted_start, -1)
        for c in range(found.shape[0]):
            seen = set(int(s) for s in state.emitted_start[c] if s >= 0)
            for k in sorted(np.flatnonzero(found[c]), key=lambda k: starts[c, k]):
                abs_start = state.consumed + int(starts[c, k])
                if abs_start in seen:
                    continue            # re-found inside the carried tail
                seen.add(abs_start)
                n += 1
                row = {"channel": c, "start": abs_start,
                       "symbols": blk.symbols[c, k],
                       "sync": int(host[3, c, k]), "cfo_bins": int(host[2, c, k]),
                       "cfo": float(host[4, c, k]), "snr_db": float(host[5, c, k]),
                       "sro_ppm": float(host[6, c, k])}
                if spec is not None:
                    row["spectra"] = spec[c, k]
                frames.append(row)
            # carry forward only the starts a tail re-scan could re-find
            live = sorted(s for s in seen if s >= new_consumed)[-self.n_recent:]
            new_recent[c, :len(live)] = live
        frames.sort(key=lambda r: (r["channel"], r["start"]))
        new_state = MeshStreamState(
            buf_r[:, -self.keep:].clone(), buf_i[:, -self.keep:].clone(),
            new_consumed, new_recent, n)
        return new_state, frames


def save_mesh_state(state: MeshStreamState, path, **extra) -> None:
    """Persist a sharded-stream carry state with the JAX twin's keys and
    dtypes (``tail_re``, ``tail_im`` float32, ``consumed``,
    ``emitted_start``, ``n_frames`` int64), so either package resumes the
    other's; ``extra`` arrays are stored beside them (the JAX loader
    ignores them). Writes to EXACTLY ``path`` (np.savez(path) would
    append '.npz')."""
    with open(path, "wb") as f:
        np.savez(f, tail_re=state.tail_re.cpu().numpy().astype(np.float32),
                 tail_im=state.tail_im.cpu().numpy().astype(np.float32),
                 consumed=np.int64(state.consumed),
                 emitted_start=np.asarray(state.emitted_start, np.int64),
                 n_frames=np.int64(state.n_frames), **extra)


def load_mesh_state(path, device=None) -> MeshStreamState:
    """The carry saved by :func:`save_mesh_state` (or by the JAX twin's),
    its tail on ``device`` (default: the first CUDA card)."""
    dev = device_of(None, device)
    with np.load(path) as z:
        return MeshStreamState(
            torch.from_numpy(z["tail_re"].astype(np.float32)).to(dev),
            torch.from_numpy(z["tail_im"].astype(np.float32)).to(dev),
            int(z["consumed"]), z["emitted_start"].astype(np.int64),
            int(z["n_frames"]))


def receive_adaptive_stream_planar(xr, xi, params: LoraParams, mesh: Mesh,
                                   max_frames: int = 4,
                                   preamble_len: int = 8,
                                   min_power_db: float | None = None,
                                   ldro: bool = False) -> list[dict]:
    """Mesh-sharded receive of SELF-DESCRIBING frames (explicit headers,
    the gateway contract of ``models.stream.AdaptiveStreamDemodulator``):
    two sharded scans bracket a host-side header loop.

    Pass 1 demodulates only the 8-symbol explicit header at every sync
    point; the host decodes each header (``models.coded.decode_header``).
    Pass 2 re-runs the sharded receiver at the LONGEST decoded frame
    length and each frame is trimmed to its own header's symbol count.
    A header whose length cannot fit one time-shard block (a long frame,
    or a corrupted length past the 5-bit checksum) gets an ``error`` info
    row instead of taking pass 2 down.

    Returns ``{channel, start, payload: bytes|None, info}`` dicts sorted by
    (channel, start); ``payload`` is None when the header was bad or the
    frame does not fit. Hard decisions only."""
    from ..models import coded

    blk = receive_stream_block_planar(
        xr, xi, params, 8, mesh, max_frames, preamble_len, min_power_db)
    found = blk.found.cpu().numpy()
    starts = blk.start.cpu().numpy()
    cfo_bins = blk.cfo_bins.cpu().numpy()
    hdr_syms = blk.symbols.cpu()

    # largest pass-2 payload-symbol count whose frame + probe margin still
    # fits one time-shard block
    step = params.step
    block = _stream_length(xr) // mesh.shape[TIME_AXIS]
    ov_w = -(-frame_overhead_samples(params, preamble_len) // step)
    n_cap = block // step - 4 - ov_w

    headers = {}                        # (channel, global_start) -> header
    nsyms = []
    for c, k in zip(*np.nonzero(found)):
        nbytes, cr, crc_en, hdr_ok = coded.decode_header(hdr_syms[c, k, :8], params.sf)
        info = {"found": True, "start": int(starts[c, k]),
                "cfo_bins": int(cfo_bins[c, k]),
                "length": int(nbytes), "cr": int(cr), "crc": bool(crc_en),
                "header_ok": bool(hdr_ok)}
        key = (int(c), int(starts[c, k]))
        if not hdr_ok or not (1 <= cr <= 4) or nbytes == 0:
            headers[key] = (None, info)
            continue
        cfg = coded.CodedConfig(sf=params.sf, cr=int(cr), crc=bool(crc_en), ldro=ldro)
        nsym = coded.payload_symbol_count(int(nbytes), cfg)
        if 8 + nsym > n_cap:
            headers[key] = (None, {
                **info, "error": "frame exceeds time-shard block; "
                "use fewer time shards or longer blocks"})
            continue
        headers[key] = (cfg, info)
        nsyms.append(nsym)
    results = [{"channel": c, "start": s, "payload": None, "info": info}
               for (c, s), (cfg, info) in headers.items() if cfg is None]
    if nsyms:
        blk2 = receive_stream_block_planar(
            xr, xi, params, 8 + max(nsyms), mesh, max_frames, preamble_len,
            min_power_db)
        f2 = blk2.found.cpu().numpy()
        s2 = blk2.start.cpu().numpy()
        for c, k in zip(*np.nonzero(f2)):
            key = (int(c), int(s2[c, k]))
            if key not in headers or headers[key][0] is None:
                continue
            cfg, info = headers[key]
            nsym = coded.payload_symbol_count(info["length"], cfg)
            payload, crc_ok, fec_err = coded.decode_payload(
                blk2.symbols[c, k, 8:8 + nsym], info["length"], cfg)
            info = {**info, "crc_ok": bool(crc_ok.all()), "fec_errors": int(fec_err)}
            results.append({"channel": key[0], "start": key[1],
                            "payload": payload.cpu().numpy().tobytes(), "info": info})
    results.sort(key=lambda r: (r["channel"], r["start"]))
    return results
