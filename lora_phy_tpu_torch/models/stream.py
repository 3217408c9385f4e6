"""Framed LoRa streams — the PyTorch twin of
``lora_phy_tpu/models/stream.py``: frame synthesis, the serial frame
receiver and the block-wise stream receivers.

A frame is ``preamble_len`` base upchirps, 2 sync-word upchirps, 2.25
base downchirps, then the payload upchirps (the standard LoRa frame the
reference documents in scripts/create_golden_vectors.cpp:95-140).

* :func:`frame_modulate` / :func:`frame_modulate_planar` build frames;
  :func:`frame_encode` builds a self-describing coded frame (explicit
  header + coded payload, :mod:`.coded`).
* :func:`frame_sync` locates the first frame of a stream with the
  two-sided scan (:func:`.sync.frame_sync_scan_planar`) and resolves the
  run-end fuzz with the JAX twin's host probe; :func:`frame_demodulate`
  demodulates it, and :func:`frame_decode_adaptive` decodes it from its
  header alone (hard or soft).
* :class:`StreamDemodulator` and :class:`AdaptiveStreamDemodulator` are
  the serial per-frame receivers over a carried tail;
  :class:`BatchStreamDemodulator` feeds fixed blocks through
  :func:`.sync.receive_block_planar`. Blocks and tails stay on the
  device; the host reads only what the JAX twin reads there (the scan's
  candidates, the probe windows, the header, the reported fields).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import LoraParams, device_of, device_table
from ..ops.chirp import (_mod_chirps_planar, base_downchirp_planar, gen_chirp_np,
                         modulate_symbols_planar)
from ..ops.planar import (_preamble_phase_step, demodulate_spectrum_planar,
                          estimate_preamble_planar)
from . import coded, modem, sync
from . import soft as softmod
from .sync import QUARTER_DEN, frame_overhead_samples


@functools.lru_cache(maxsize=16)
def _down_section(n: int, osr: int, scale: float, amplitude: float):
    """(re, im) float32 planes of the phase-continuous 2.25-symbol
    downchirp, from the float64 host oracle (as the JAX twin)."""
    step = n * osr
    down, _ = gen_chirp_np(n, osr, 2 * step + step // QUARTER_DEN, 0.0,
                           down=True, ampl=amplitude, bw_scale=scale)
    return (np.ascontiguousarray(down.real.astype(np.float32)),
            np.ascontiguousarray(down.imag.astype(np.float32)))


def frame_modulate(symbols, params: LoraParams, preamble_len: int = 8,
                   amplitude: float = 1.0, symbol_phase_carry: bool = True,
                   device=None) -> torch.Tensor:
    """Full LoRa frames as complex64: ``preamble_len`` base upchirps, 2
    sync-word upchirps, 2.25 base downchirps, then the payload upchirps.
    [..., S] symbols -> [..., overhead + S*step], bit-equal to the JAX
    twin and to ``torch.complex(*frame_modulate_planar(...))``.

    ``symbol_phase_carry=False`` starts every symbol chirp at phase 0
    (the gr-lora_sdr modulator builds each symbol independently)."""
    return torch.complex(*_frame_planes(symbols, params, preamble_len, amplitude,
                                        None, symbol_phase_carry, device))


def frame_modulate_planar(symbols, params: LoraParams,
                          preamble_len: int = 8, amplitude: float = 1.0,
                          sync_symbols=None, device=None):
    """Full frames as (re, im) float32 planes, bit-exact with the JAX
    twin: [..., S] symbols -> each [..., overhead + S*step]. ``symbols``
    is a tensor, computed on where it lives, or an integer array together
    with ``device=``.

    ``sync_symbols``: optional ``[..., 2]`` sync-chirp symbol values that
    override ``params.sync_word`` (a frame resynthesized with the sync
    word a receiver recovered)."""
    return _frame_planes(symbols, params, preamble_len, amplitude,
                         sync_symbols, True, device)


def _frame_planes(symbols, params: LoraParams, preamble_len: int,
                  amplitude: float, sync_symbols, phase_carry: bool, device):
    """The (re, im) planes of :func:`frame_modulate` and
    :func:`frame_modulate_planar`."""
    dev = device_of(symbols, device)
    symbols = torch.as_tensor(symbols, device=dev)
    step = params.step
    lead = symbols.shape[:-1]
    if sync_symbols is None:
        br, bi = modulate_symbols_planar(
            symbols, params.sf, params.osr, params.scale, amplitude,
            params.sync_word, params.continuous_chirp, phase_carry)
    else:
        sync_symbols = torch.as_tensor(sync_symbols, device=dev)
        allsyms = torch.cat([sync_symbols.to(torch.int32),
                             symbols.to(torch.int32)], dim=-1)
        ampl_c = float(np.clip(amplitude, -1.0, 1.0))
        re_c, im_c = _mod_chirps_planar(
            allsyms, params.n, params.osr, int(round(params.scale * 8)),
            ampl_c, params.continuous_chirp, phase_carry)
        br = re_c.reshape(*re_c.shape[:-2], -1)
        bi = im_c.reshape(*im_c.shape[:-2], -1)
    zeros = torch.zeros(*lead, preamble_len - 2, dtype=torch.int32, device=dev)
    pr, pi = modulate_symbols_planar(
        zeros, params.sf, params.osr, params.scale, amplitude, 0x00,
        params.continuous_chirp, phase_carry)
    down = device_table(_down_section, params.n, params.osr, params.scale,
                        float(amplitude), device=dev)
    out = []
    for body, pre, d in ((br, pr, down[0]), (bi, pi, down[1])):
        out.append(torch.cat(
            [pre[..., : preamble_len * step], body[..., : 2 * step],
             d.expand(*lead, d.shape[-1]), body[..., 2 * step:]], dim=-1))
    return tuple(out)


class FrameSyncResult(NamedTuple):
    found: bool
    start: int            # sample index of the frame's first preamble sample
    cfo_bins: int         # integer CFO estimate in FFT bins
    payload_start: int    # sample index where payload symbols begin


_NOT_FOUND = FrameSyncResult(False, 0, 0, 0)


def _as_stream(stream) -> torch.Tensor:
    """A single-channel stream as a complex64 tensor: a tensor stays
    where it lives, an array goes to the first CUDA card."""
    return torch.as_tensor(stream, device=device_of(stream)).to(torch.complex64)


@functools.lru_cache(maxsize=16)
def _host_downchirp(sf: int, bw_scale: float, osr: int) -> np.ndarray:
    """The base downchirp as a host complex64 array (the JAX twin's
    ``np.asarray(base_downchirp(...))``)."""
    re, im = base_downchirp_planar(sf, bw_scale, osr)
    out = np.empty(re.shape, np.complex64)
    out.real, out.imag = re, im
    return out


def frame_sync(stream, params: LoraParams, preamble_len: int = 8,
               min_power_db: float | None = None) -> FrameSyncResult:
    """Locate the first frame in a continuous single-channel stream.

    The scan (:func:`.sync.frame_sync_scan_planar`) runs on the stream's
    device; the host reads its per-window ``valid`` / ``start`` /
    ``cfo_bins`` in one copy and picks the first valid candidate. The
    run-end fuzz (the true start is ``start`` or ``start + step``) is
    resolved by the JAX twin's probe: up-dechirped window 9 (second sync
    upchirp) plus down-dechirped window 10 (first full SFD downchirp),
    scored by the peak of a host ``np.fft.fft``. The three windows both
    hypotheses read are copied to the host and scored with the same
    NumPy arithmetic, so the decision is the JAX twin's bit for bit.
    ``min_power_db`` gates candidates on preamble peak power."""
    stream = _as_stream(stream)
    step, n, osr = params.step, params.n, params.osr
    nwin = int(stream.shape[-1]) // step
    if nwin < preamble_len + 5:
        return _NOT_FOUND
    scan = sync.frame_sync_scan_planar(
        stream.real.contiguous(), stream.imag.contiguous(), params,
        preamble_len, min_power_db=min_power_db)
    valid, starts, cfos = torch.stack(
        [scan.valid.to(torch.int32), scan.start, scan.cfo_bins]).cpu().numpy()
    down = _host_downchirp(params.sf, params.scale, osr)
    for w in np.flatnonzero(valid):
        start, cfo_bins = int(starts[w]), int(cfos[w])
        # stream[lo:hi] covers every probe window of both hypotheses
        lo = max(start + (preamble_len + 1) * step, 0)
        hi = max(start + (preamble_len + 4) * step, 0)
        host = stream[lo:hi].cpu().numpy()

        def _peak(pos, ref):
            seg = np.zeros(step, np.complex64)
            src = host[max(pos, 0) - lo: max(pos + step, 0) - lo]
            seg[: src.shape[-1]] = src
            spec = np.fft.fft((seg * ref).reshape(n, osr)[:, 0])
            return float(np.max(np.abs(spec)))

        def score(s0):
            return (_peak(s0 + (preamble_len + 1) * step, down)
                    + _peak(s0 + (preamble_len + 2) * step, np.conj(down)))

        if score(start + step) > score(start):
            start += step
        if start < 0:
            continue                  # unrescued negative-start alias:
            #                           try the next candidate window
        payload_start = start + frame_overhead_samples(params, preamble_len)
        return FrameSyncResult(True, start, cfo_bins, payload_start)
    return _NOT_FOUND


def first_candidate(scan) -> tuple[int, int] | None:
    """(start, cfo_bins) of the first valid candidate in a 1-D SyncScan."""
    hits = np.flatnonzero(scan.valid.cpu().numpy())
    if hits.size == 0:
        return None
    w = int(hits[0])
    return int(scan.start[w]), int(scan.cfo_bins[w])


def _derotate(x: torch.Tensor, cfo_bins: int, step: int) -> torch.Tensor:
    """``x * exp(1j * ph)`` with ``ph = f32(-2*pi*cfo_bins/step) * i`` in
    float32, the JAX twin's integer-CFO derotation."""
    idx = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
    ph = idx * float(np.float32(-2.0 * math.pi * cfo_bins / step))
    return x * torch.complex(torch.cos(ph), torch.sin(ph))


def frame_demodulate(stream, params: LoraParams, n_payload_symbols: int,
                     preamble_len: int = 8,
                     min_power_db: float | None = None,
                     return_spectra: bool = False,
                     tx_phase_step: float | None = None,
                     sync_result: FrameSyncResult | None = None):
    """Sync + demodulate one frame from a continuous stream. Returns
    ``(DemodResult | None, sync_result)``: ``symbols`` [n_payload_symbols]
    int32 on the stream's device. The payload section is dechirped with
    the sync pair re-attached and demodulated through
    :func:`.modem.demodulate` (the plain path, as the JAX twin's), with
    the residual CFO anchored on the preamble
    (:func:`..ops.planar.estimate_preamble_planar`).

    ``return_spectra=True`` returns ``(out, res, mag2)`` with ``mag2`` the
    [n_payload_symbols, N] |DFT|² of the data symbols (the soft-decision
    input, :mod:`.soft`). ``tx_phase_step``: the transmitter's
    inter-symbol phase delta on preamble upchirps (``None`` = this
    framework's own modulator; ``0.0`` for gr-lora_sdr transmitters).
    ``sync_result``: a precomputed :func:`frame_sync` result, so the
    whole-stream scan is not run again."""
    stream = _as_stream(stream)
    res = sync_result if sync_result is not None else frame_sync(
        stream, params, preamble_len, min_power_db=min_power_db)
    if not res.found:
        return None, res
    step = params.step
    sync_start = res.start + preamble_len * step
    pre_sec = stream[..., res.start: sync_start]
    sync_sec = stream[..., sync_start: sync_start + 2 * step]
    payload_sec = stream[..., res.payload_start:
                         res.payload_start + n_payload_symbols * step]
    if payload_sec.shape[-1] < n_payload_symbols * step:
        return None, FrameSyncResult(False, res.start, res.cfo_bins, res.payload_start)
    window = torch.cat([sync_sec, payload_sec], dim=-1)
    if res.cfo_bins != 0:
        # undo the integer-bin CFO found by the two-sided sync
        window = _derotate(window, res.cfo_bins, step)
        pre_sec = _derotate(pre_sec, res.cfo_bins, step)
    pre_dech = modem.dechirp(pre_sec, params)
    if tx_phase_step is None:
        tx_phase_step = _preamble_phase_step(params.sf, params.osr, params.scale)
    cfo_resid = estimate_preamble_planar(
        pre_dech.real.contiguous(), pre_dech.imag.contiguous(),
        params.n, params.osr, phase_step=tx_phase_step)
    offsets = (cfo_resid, torch.zeros_like(cfo_resid))
    dech = modem.dechirp(window, params)
    out = modem.demodulate(dech, params, known_offsets=offsets)
    if not return_spectra:
        return out, res
    mag2, _, _, _ = demodulate_spectrum_planar(
        dech.real.contiguous(), dech.imag.contiguous(), params,
        known_offsets=offsets)
    return out, res, mag2


class StreamState(NamedTuple):
    """Carried tail between blocks of the serial receivers: the last
    samples of the previous blocks (a complex64 device tensor) and the
    absolute sample index of the tail's first sample."""

    tail: torch.Tensor
    consumed: int


def _init_stream_state(device) -> StreamState:
    return StreamState(torch.zeros(0, dtype=torch.complex64,
                                   device=device_of(None, device)), 0)


def _extend(state: StreamState, block) -> torch.Tensor:
    """The tail followed by ``block`` (a tensor or an array), on the
    tail's device."""
    block = torch.as_tensor(block, device=state.tail.device).to(torch.complex64)
    return torch.cat([state.tail, block], dim=-1)


class StreamDemodulator:
    """Block-wise frame receiver over a continuous stream, one frame at a
    time (:func:`frame_demodulate`).

    Feed arbitrary consecutive blocks; frames fully contained in
    (tail + block) are demodulated and returned; the unconsumed tail
    carries forward. Block size must exceed one frame length.
    """

    def __init__(self, params: LoraParams, n_payload_symbols: int,
                 preamble_len: int = 8, device=None):
        self.params = params
        self.n_payload_symbols = n_payload_symbols
        self.preamble_len = preamble_len
        self.device = device
        self.frame_len = (
            frame_overhead_samples(params, preamble_len)
            + n_payload_symbols * params.step
        )

    def init_state(self) -> StreamState:
        return _init_stream_state(self.device)

    def process(self, state: StreamState, block):
        """Returns (new_state, list of (abs_start, DemodResult))."""
        buf = _extend(state, block)
        base = state.consumed
        frames = []
        offset = 0
        while buf.shape[-1] - offset >= self.frame_len:
            out, res = frame_demodulate(
                buf[offset:], self.params, self.n_payload_symbols, self.preamble_len
            )
            if out is None:
                if not res.found and res.payload_start > 0:
                    # frame detected but its payload runs past the block
                    # end: carry everything from the frame start forward
                    offset += res.start
                break
            frames.append((base + offset + res.start, out))
            # continue scanning right after this frame's payload
            offset += res.payload_start + self.n_payload_symbols * self.params.step
        keep = min(buf.shape[-1] - offset, self.frame_len + self.params.step)
        new_tail = buf[buf.shape[-1] - keep:]
        return StreamState(new_tail, base + buf.shape[-1] - keep), frames


class PlanarStreamState(NamedTuple):
    """Stream carry of :class:`BatchStreamDemodulator`: the unconsumed
    tail planes (device tensors) and the absolute sample index of the
    tail's first sample."""

    tail_re: torch.Tensor
    tail_im: torch.Tensor
    consumed: int

    @classmethod
    def from_numpy(cls, tail_re, tail_im, consumed, device=None):
        """The carry from host arrays — e.g. the fields of the JAX
        package's ``PlanarStreamState`` — on ``device`` (default: the
        first CUDA card), so a stream resumes in the port."""
        dev = device_of(None, device)
        return cls(torch.tensor(np.asarray(tail_re, np.float32), device=dev),
                   torch.tensor(np.asarray(tail_im, np.float32), device=dev),
                   int(consumed))


class BatchStreamDemodulator:
    """Block-wise frame receiver: per block, the scan, candidate
    selection, window extraction, CFO derotation, dechirp and demod of up
    to ``max_frames`` frames run through :func:`.sync.receive_block_planar`
    on the device; the host reads the few per-frame fields it needs to
    report frames and place the carry. Feed blocks of any size."""

    def __init__(self, params: LoraParams, n_payload_symbols: int,
                 preamble_len: int = 8, max_frames: int = 8, device=None):
        self.params = params
        self.n_payload_symbols = n_payload_symbols
        self.preamble_len = preamble_len
        self.max_frames = max_frames
        self.device = device
        self.frame_len = (
            frame_overhead_samples(params, preamble_len)
            + n_payload_symbols * params.step
        )

    def init_state(self) -> PlanarStreamState:
        z = torch.zeros(0, dtype=torch.float32,
                        device=device_of(None, self.device))
        return PlanarStreamState(z, z, 0)

    def process(self, state: PlanarStreamState, block_re, block_im):
        """Returns ``(new_state, frames)``, ``frames`` a list of
        ``(abs_start, symbols [S] int32 tensor, sync, cfo_bins)``."""
        dev = state.tail_re.device
        buf_re = torch.cat([state.tail_re, torch.as_tensor(
            block_re, dtype=torch.float32, device=dev)])
        buf_im = torch.cat([state.tail_im, torch.as_tensor(
            block_im, dtype=torch.float32, device=dev)])
        base = state.consumed
        blk = sync.receive_block_planar(
            buf_re, buf_im, self.params, self.n_payload_symbols,
            self.max_frames, self.preamble_len,
        )
        found, starts, syncs, cfo_bins = (
            t.cpu().tolist() for t in (blk.found, blk.start, blk.sync,
                                       blk.cfo_bins))
        frames = []
        last_end = 0
        for k in np.flatnonzero(found):
            frames.append((base + starts[k], blk.symbols[k], syncs[k],
                           cfo_bins[k]))
            last_end = starts[k] + self.frame_len
        size = buf_re.shape[0]
        if all(found):
            # the block may hold more than max_frames: keep everything
            # after the last extracted frame for the next pass
            offset = last_end
        else:
            offset = max(last_end, size - self.frame_len - self.params.step)
        offset = max(0, min(offset, size))
        new_state = PlanarStreamState(buf_re[offset:], buf_im[offset:],
                                      base + offset)
        return new_state, frames


# ---------------------------------------------------------------------------
# Checkpoint / resume of the serial receivers' carry
# ---------------------------------------------------------------------------

def save_state(state: StreamState, path) -> None:
    """Persist a stream carry state (tail samples + absolute position) as
    the JAX twin's ``.npz`` fields (``tail_re``, ``tail_im``, ``consumed``),
    so a carry written by either package resumes in the other. Writes to
    EXACTLY ``path`` (a bare np.savez(path) would append '.npz')."""
    tail = state.tail.cpu().numpy()
    with open(path, "wb") as f:
        np.savez(f, tail_re=tail.real.astype(np.float32),
                 tail_im=tail.imag.astype(np.float32),
                 consumed=np.int64(state.consumed))


def load_state(path, device=None) -> StreamState:
    """The carry saved by :func:`save_state` (or by the JAX twin's), on
    ``device`` (default: the first CUDA card)."""
    with np.load(path) as z:
        tail = (z["tail_re"] + 1j * z["tail_im"]).astype(np.complex64)
        consumed = int(z["consumed"])
    return StreamState(torch.from_numpy(tail).to(device_of(None, device)), consumed)


# ---------------------------------------------------------------------------
# Header-driven (adaptive) framing: payload length learned from the
# explicit header, so streams may carry frames of arbitrary sizes
# ---------------------------------------------------------------------------

def frame_encode(payload, cfg: coded.CodedConfig, params: LoraParams,
                 preamble_len: int = 8, device=None) -> torch.Tensor:
    """Full self-describing frame as complex64: explicit header
    (:func:`.coded.encode_header`) + coded payload, wrapped in
    preamble/sync/2.25-downchirp framing. ``payload`` is a 1-D byte
    tensor or array (with ``device=``; default the first CUDA card)."""
    payload = torch.as_tensor(payload, device=device_of(payload, device)).to(torch.uint8)
    hdr = coded.encode_header(int(payload.shape[-1]), cfg, device=payload.device)
    body = coded.encode_payload(payload, cfg)
    return frame_modulate(torch.cat([hdr, body], dim=-1), params,
                          preamble_len=preamble_len)


def _to_host(*tensors) -> list[np.ndarray]:
    """Several small tensors read to the host in ONE copy (one device
    sync): flattened into float64, which holds bytes, counts and float32
    values exactly, and split back."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    out, pos = [], 0
    for t in tensors:
        out.append(flat[pos: pos + t.numel()])
        pos += t.numel()
    return out


def frame_decode_adaptive(samples, params: LoraParams, preamble_len: int = 8,
                          soft: bool = False, ldro: bool = False,
                          min_power_db: float | None = None):
    """Sync one frame and decode it using only the stream contents: the
    8-symbol explicit header supplies payload length, CR and CRC mode.

    Returns ``(payload bytes | None, info dict, consumed_samples)``, as
    the JAX twin. ``soft=True`` decodes the payload from the symbol
    spectra by ML codeword correlation (:mod:`.soft`); the header stays
    hard-decided. Host reads: the sync scan's candidates and probe
    windows, the 8 header bins, then the payload, ``crc_ok``,
    ``fec_errors`` (and ``soft_margin``) in one copy."""
    samples = _as_stream(samples)
    res = frame_sync(samples, params, preamble_len, min_power_db=min_power_db)
    if not res.found:
        return None, {"found": False}, 0
    step = params.step
    avail = (samples.shape[-1] - res.payload_start) // step
    if avail < 8:
        return None, {"found": False}, 0
    # cap at the longest possible frame (255-byte payload + CRC at CR
    # 4/8, under the configured rate)
    worst = 8 + coded.payload_symbol_count(
        255, coded.CodedConfig(sf=params.sf, cr=4, ldro=ldro))
    avail = min(int(avail), worst)

    dm = frame_demodulate(samples, params, avail, preamble_len,
                          return_spectra=soft, sync_result=res)
    out = dm[0]
    if out is None:
        return None, {"found": False}, 0
    bins = out.symbols

    nbytes, cr, crc_en, hdr_ok = coded.decode_header(bins[:8], params.sf)
    info = {
        "found": True, "start": res.start, "cfo_bins": res.cfo_bins,
        "length": nbytes, "cr": cr, "crc": crc_en, "header_ok": hdr_ok,
    }
    if not hdr_ok or not (1 <= cr <= 4) or nbytes == 0:
        return None, info, res.start + step
    # LDRO is channel configuration (not signalled in the header): the
    # caller supplies it
    cfg = coded.CodedConfig(sf=params.sf, cr=cr, crc=crc_en, ldro=ldro)
    nsym = coded.payload_symbol_count(nbytes, cfg)
    if bins.shape[-1] - 8 < nsym:
        return None, {**info, "truncated": True}, 0
    if soft:
        payload, crc_ok, margin = softmod.decode_payload_soft(
            dm[2][8:8 + nsym], nbytes, cfg)
        payload, crc_ok, margin = _to_host(payload, crc_ok, margin)
        info["soft_margin"] = float(margin[0])
        fec_err = 0
    else:
        payload, crc_ok, fec_err = _to_host(*coded.decode_payload(
            bins[8:8 + nsym], nbytes, cfg))
    info["crc_ok"] = bool(np.all(crc_ok))
    info["fec_errors"] = int(np.sum(fec_err))
    consumed = res.payload_start + (8 + nsym) * step
    return payload.astype(np.uint8).tobytes(), info, consumed


class AdaptiveStreamDemodulator:
    """Block-wise receiver for self-describing frames (explicit headers):
    no prior knowledge of payload sizes; carries a tail between blocks.
    A serial host loop that scans the buffer again per frame, as the JAX
    twin's; the buffer stays on the device."""

    def __init__(self, params: LoraParams, preamble_len: int = 8,
                 max_frame_len: int | None = None, soft: bool = False,
                 ldro: bool = False, min_power_db: float | None = None,
                 device=None):
        self.params = params
        self.preamble_len = preamble_len
        self.soft = soft
        self.ldro = ldro
        self.min_power_db = min_power_db
        self.device = device
        # worst case: 255-byte payload + CRC at CR 4/8 (LDRO frames run
        # at PPM = sf-2 and are longer)
        if max_frame_len is None:
            worst = coded.payload_symbol_count(
                255, coded.CodedConfig(sf=params.sf, cr=4, ldro=ldro))
            max_frame_len = (frame_overhead_samples(params, preamble_len)
                             + (8 + worst) * params.step)
        self.max_frame_len = max_frame_len

    def init_state(self) -> StreamState:
        return _init_stream_state(self.device)

    def process(self, state: StreamState, block):
        """Returns (new_state, list of (abs_start, payload bytes, info))."""
        buf = _extend(state, block)
        base = state.consumed
        frames = []
        offset = 0
        while buf.shape[-1] - offset >= 16 * self.params.step:
            payload, info, consumed = frame_decode_adaptive(
                buf[offset:], self.params, self.preamble_len,
                soft=self.soft, ldro=self.ldro,
                min_power_db=self.min_power_db,
            )
            if payload is not None:
                frames.append((base + offset + info["start"], payload, info))
                offset += consumed
            elif info.get("found") and consumed > 0:
                offset += consumed      # bad header: skip this sync point
            else:
                break                   # nothing (or truncated): wait for more
        keep = min(buf.shape[-1] - offset, self.max_frame_len + self.params.step)
        new_tail = buf[buf.shape[-1] - keep:]
        return StreamState(new_tail, base + buf.shape[-1] - keep), frames
