"""High-level LoRa modem on tensors — the PyTorch twin of
``lora_phy_tpu/models/modem.py``.

``encode`` / ``decode`` / ``decode_with_crc`` are the simple Hamming 8/4
chain. The complex64 API (``modulate``, ``dechirp``, ``demodulate``,
``demodulate_integrated`` and the estimate / compensate functions of
phy.cpp) is written as thin wrappers over the planar pipeline in
:mod:`..ops.planar` (on CUDA complex64 is native, so there is no second
pipeline to keep equal). The private helpers below are the ones the
planar demodulator shares with this module in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import LoraParams, Window, device_of, device_table
from ..ops import coding
from ..utils.profiling import host_sync, stage_range

_TWO_PI = 2.0 * math.pi
_TWO_PI_F32 = float(np.float32(_TWO_PI))


class DemodResult(NamedTuple):
    symbols: torch.Tensor      # [..., S] int32 data symbols (sync removed)
    sync_word: torch.Tensor    # [...] recovered sync byte (uint8)
    cfo: torch.Tensor          # [...] estimated carrier frequency offset
    time_offset: torch.Tensor  # [...] estimated timing offset (samples)


class DecodeResult(NamedTuple):
    payload: torch.Tensor      # [..., B] decoded bytes (uint8)
    crc_ok: torch.Tensor       # [...] bool, SX1272 CRC16 over payload[2:-2]


# ---------------------------------------------------------------------------
# Encode / decode (simple Hamming(8,4) chain of the reference)
# ---------------------------------------------------------------------------

def encode(payload, device=None) -> torch.Tensor:
    """Byte stream -> Hamming(8,4) codeword symbols, two per byte
    (reference: src/phy/LoRaEncoder.cpp:6-18). [..., B] -> [..., 2B] int32
    (the JAX twin returns uint16).

    ``payload`` is a uint8 tensor, computed on where it lives, or any
    array of bytes together with an explicit ``device=``."""
    payload = torch.as_tensor(payload, device=device_of(payload, device))
    nibbles = coding.bytes_to_nibbles(payload)
    return coding.hamming84_encode(nibbles).to(torch.int32)


def decode(symbols: torch.Tensor) -> torch.Tensor:
    """Symbol pairs -> bytes via Hamming(8,4) correction
    (reference: src/phy/LoRaDecoder.cpp:6-19). [..., 2B] -> [..., B] uint8.
    Runs in the range ``modem.decode`` while a profiler runs."""
    with stage_range("modem.decode"):
        n = symbols.shape[-1] - (symbols.shape[-1] % 2)
        nibbles, _, _ = coding.hamming84_decode(symbols[..., :n])
        return coding.nibbles_to_bytes(nibbles & 0x0F)


def decode_with_crc(symbols: torch.Tensor) -> DecodeResult:
    """Decode + SX1272 CRC16 verification over ``payload[2:-2]`` against the
    trailing little-endian CRC bytes (reference: src/phy/phy.cpp:241-256)."""
    payload = decode(symbols)
    nbytes = payload.shape[-1]
    if nbytes >= 4:
        data = payload[..., 2:-2]
        provided = payload[..., -2].to(torch.int32) | (
            payload[..., -1].to(torch.int32) << 8)
        crc_ok = provided == coding.crc16_sx1272(data)
    else:
        crc_ok = torch.zeros(payload.shape[:-1], dtype=torch.bool,
                             device=payload.device)
    return DecodeResult(payload, crc_ok)


# ---------------------------------------------------------------------------
# Complex API over the planar pipeline
# ---------------------------------------------------------------------------

def modulate(symbols: torch.Tensor, params: LoraParams,
             amplitude: float = 1.0) -> torch.Tensor:
    """Symbols -> phase-continuous chirped complex64 IQ with the 2-symbol
    sync preamble (reference: src/phy/LoRaMod.cpp:8-43).
    [..., S] -> [..., (S+2)*step]."""
    from ..ops.planar import modulate_planar

    return torch.complex(*modulate_planar(symbols, params, amplitude))


def dechirp(iq: torch.Tensor, params: LoraParams) -> torch.Tensor:
    """External dechirp: multiply every symbol period by the base downchirp,
    the working-path contract (reference: tests/e2e_chain_test.cpp:80-93)."""
    from ..ops.planar import dechirp_planar

    return torch.complex(*dechirp_planar(iq.real, iq.imag, params))


def demodulate(samples: torch.Tensor, params: LoraParams,
               backend: str = "xla", known_offsets=None) -> DemodResult:
    """Demodulate already-dechirped complex64 samples — the reference's
    working contract (``lora_demodulate``, src/phy/LoRaDemod.cpp:49-195),
    a wrapper over :func:`..ops.planar.demodulate_planar`.

    ``samples``: [..., S_total*step] (S_total >= 2; the first two symbols
    are the sync word). Returns data symbols [..., S_total-2] (int32), the
    sync byte and the CFO/TO estimates. ``known_offsets=(cfo, time_offset)``
    bypasses the 2-symbol estimator. ``backend`` is checked by
    :func:`_check_backend`."""
    from ..ops.planar import demodulate_planar, split_complex

    _check_backend(backend)
    res = demodulate_planar(*split_complex(samples), params,
                            known_offsets=known_offsets)
    return DemodResult(*res)


def _check_backend(backend: str) -> None:
    """The JAX twin's ``backend=`` picks the FFT of its complex detector:
    ``xla`` (XLA's FFT), ``dft`` (dense DFT matmuls, the four-step above
    N = 128) or ``auto``. The port's complex demodulators are wrappers over
    the planar pipeline, whose DFT is the ``dft`` formulation itself, so
    every name computes that one pipeline; an unknown name raises."""
    if backend not in ("xla", "dft", "auto"):
        raise ValueError(f"unknown backend {backend!r} (xla, dft or auto)")


# ---------------------------------------------------------------------------
# estimate / compensate (public API parity with phy.cpp)
# ---------------------------------------------------------------------------

def estimate_offsets(samples: torch.Tensor, params: LoraParams,
                     backend: str = "xla"):
    """CFO/TO estimation over whole symbols (reference: src/phy/phy.cpp:78-145;
    this variant has no argmax-index tie-break across osr phases)."""
    _check_backend(backend)
    return _estimate(samples, params.n, params.osr,
                     _window_tensor(params, samples.device), tie_break_idx=False)


def compensate_offsets(samples: torch.Tensor, params: LoraParams, cfo,
                       time_offset) -> torch.Tensor:
    """Derotate by the estimated CFO and shift by the integer timing offset
    with zero fill (reference: src/phy/phy.cpp:147-176): a complex64
    wrapper over :func:`..ops.planar.compensate_offsets_planar`."""
    from ..ops.planar import compensate_offsets_planar

    return torch.complex(*compensate_offsets_planar(
        samples.real, samples.imag, params, cfo, time_offset))


def estimate_sro(samples: torch.Tensor, params: LoraParams) -> torch.Tensor:
    """Sample-rate-offset (clock-drift) estimate in ppm from DECHIRPED
    symbol windows — a complex64 wrapper over
    :func:`..ops.planar.estimate_sro_planar` (see there for the method)."""
    from ..ops.planar import estimate_sro_planar

    return estimate_sro_planar(samples.real.to(torch.float32),
                               samples.imag.to(torch.float32), params)


# ---------------------------------------------------------------------------
# Integrated demodulator (quirk-compat port of phy.cpp demodulate)
# ---------------------------------------------------------------------------

def demodulate_integrated(iq: torch.Tensor, params: LoraParams,
                          backend: str = "xla",
                          quirk_compat: bool = False) -> DemodResult:
    """Integrated demodulation of raw chirped IQ
    (reference: src/phy/phy.cpp:178-239): per-symbol dechirp with the base
    downchirp, CFO derotation, DFT argmax, sync extraction, on the planar
    pipeline's stages.

    ``quirk_compat=True`` reproduces the reference defect of estimating
    CFO/TO on the *raw* sync chirps (phy.cpp:192-193), which corrupts the
    decisions (SURVEY.md §2.3 finding 2). The default estimates on the
    sync symbols dechirped with the oversampled downchirp, so the
    integrated path round-trips."""
    from ..ops.chirp import base_downchirp_planar
    from ..ops.planar import (_estimate_planar, _rotated_windows_planar,
                              argmax_bins_planar, dechirp_planar, split_complex)

    _check_backend(backend)
    n, osr, step = params.n, params.osr, params.step
    total_symbols = iq.shape[-1] // step
    if total_symbols < 2:
        raise ValueError("need at least the 2 sync symbols")
    xr, xi = split_complex(iq[..., : total_symbols * step])
    er, ei = xr[..., : 2 * step], xi[..., : 2 * step]
    if not quirk_compat:
        er, ei = dechirp_planar(er, ei, params)
    cfo, time_offset = _estimate_planar(er, ei, n, osr,
                                        _window_tensor(params, xr.device),
                                        tie_break_idx=False)
    t_off = _round_half_away(time_offset).to(torch.int32)
    rate = -_TWO_PI_F32 * cfo / float(n)
    yr = _shifted_symbol_gather(xr, total_symbols, n, osr, t_off)  # [..., S, N]
    yi = _shifted_symbol_gather(xi, total_symbols, n, osr, t_off)
    # dechirp by the osr-1 base downchirp (phy.cpp:203, 221)
    dr, di = device_table(base_downchirp_planar, params.sf, params.scale, 1,
                          device=xr.device)
    yr, yi = yr * dr - yi * di, yr * di + yi * dr
    fr, fi = _rotated_windows_planar(yr, yi, rate, t_off, None, params)
    syms = argmax_bins_planar(fr, fi, n)
    sync = _sync_from_symbols(syms[..., 0], syms[..., 1], params.sf)
    return DemodResult(syms[..., 2:], sync, cfo, time_offset)


# ---------------------------------------------------------------------------
# Helpers shared with the planar demodulator
# ---------------------------------------------------------------------------

def _window_table(params: LoraParams) -> np.ndarray | None:
    if params.window == Window.NONE:
        return None
    n = params.n
    i = np.arange(n, dtype=np.float32)
    # Hann per the reference (src/phy/LoRaDemod.cpp:17-22), float32
    return (0.5 - 0.5 * np.cos(2.0 * np.float32(math.pi) * i / np.float32(n - 1))).astype(
        np.float32
    )


def _window_tensor(params: LoraParams, device):
    """The Hann window as a device tensor, or None."""
    return device_table(_window_table, params, device=device)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """std::round semantics (half away from zero) — torch.round is half-even."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def _wrap_pi(d: torch.Tensor) -> torch.Tensor:
    """The reference's while-loop phase wrap into [-pi, pi]
    (src/phy/LoRaDemod.cpp:116-118); inputs are within +-2pi."""
    d = torch.where(d > math.pi, d - _TWO_PI, d)
    return torch.where(d < -math.pi, d + _TWO_PI, d)


def _osr_phase_view(x: torch.Tensor, n: int, osr: int) -> torch.Tensor:
    """[..., S*step] -> [..., S, osr, N] where [..., s, t, i] = x[s*step + t + i*osr]."""
    s = x.shape[-1] // (n * osr)
    return x[..., : s * n * osr].reshape(*x.shape[:-1], s, n, osr).swapaxes(-1, -2)


def _tie_power_db(xr: torch.Tensor, xi: torch.Tensor, index: torch.Tensor,
                  n: int) -> torch.Tensor:
    """The detector's peak power in dB (float32), recomputed for the
    estimator's osr-phase pick: the DFT value at the float32 argmax bin
    ``index`` taken in float64 from the float32 windows ``[..., N]``,
    then rounded where the float32 detector rounds (``20*log10`` of the
    fundamental, then minus ``20*log10(N)``).

    The pick compares the osr phases' powers by exact equality
    (src/phy/LoRaDemod.cpp:85-135). A clean tone has the same true power
    at several phases; the JAX twin's float32 sums then tie, and another
    summation order (torch's matmul) can break the tie by one ulp of
    ``20*log10`` (3.8e-6 dB at N = 128) and pick another phase. In float64
    the equal true powers round to the same float32, while powers that
    differ by more than the float32 sums' error keep their order."""
    j = torch.arange(n, dtype=torch.int64, device=xr.device)
    m = torch.remainder(index.to(torch.int64)[..., None] * j, n)
    ang = m.to(torch.float64) * (_TWO_PI / n)
    c, s = torch.cos(ang), -torch.sin(ang)
    ar, ai = xr.to(torch.float64), xi.to(torch.float64)
    yr = torch.sum(ar * c - ai * s, dim=-1)
    yi = torch.sum(ar * s + ai * c, dim=-1)
    v = (20.0 * torch.log10(torch.sqrt(yr * yr + yi * yi))).to(torch.float32)
    return v - 20.0 * torch.log10(torch.tensor(float(n), device=xr.device))


def _pick_osr_phase(p: torch.Tensor, idx: torch.Tensor,
                    tie_break_idx: bool) -> torch.Tensor:
    """The winning osr phase per symbol from powers ``p`` and bins ``idx``
    ``[..., S, osr]``: the greatest power, first phase on a tie, and with
    ``tie_break_idx`` the lowest bin among the tied phases first
    (src/phy/LoRaDemod.cpp:85-135)."""
    maxp = p.amax(dim=-1, keepdim=True)
    cand = p == maxp
    if tie_break_idx:
        idx_masked = torch.where(cand, idx, torch.iinfo(torch.int32).max)
        min_idx = idx_masked.amin(dim=-1, keepdim=True)
        cand = cand & (idx_masked == min_idx)
    return torch.argmax(cand.to(torch.int32), dim=-1)   # first winning phase


def _estimate(x: torch.Tensor, n: int, osr: int, window, tie_break_idx: bool):
    """Per-frame CFO/TO estimate over the complex64 symbols in ``x``: a
    wrapper over :func:`..ops.planar._estimate_planar` (see there)."""
    from ..ops.planar import _estimate_planar, split_complex

    return _estimate_planar(*split_complex(x), n, osr, window, tie_break_idx)


def _derotation_vector(rate: torch.Tensor, n: int):
    """Per-sample CFO derotation ``exp(j*rate*i)`` over [..., N], broadcast
    over the symbol axis by the caller, as its (cos, sin) planes (the JAX
    twin returns the complex vector; the planar pipeline takes the planes
    and so makes no complex copy). The reference's per-symbol constant
    phase ``rate*(s*N + t_off/osr)`` (src/phy/LoRaDemod.cpp:151-152) leaves
    every magnitude unchanged and is dropped, as in the JAX twin."""
    phi = rate[..., None] * torch.arange(n, dtype=torch.float32, device=rate.device)
    return torch.cos(phi), torch.sin(phi)


def _shifted_rows(x: torch.Tensor, t_off: torch.Tensor, step: int) -> torch.Tensor:
    """Whole-row timing shift ``y[..., j] = x[..., j + t_off]`` with zero
    fill: one index gather into a copy of ``x`` padded by ``step`` on both
    sides (``t_off`` is [...] int, broadcast over the rows).

    Offsets beyond one symbol (only reachable through ``known_offsets``)
    follow the JAX twin's ``dynamic_slice``: a negative start counts from
    the end of the padded row, then the start is clamped into it."""
    count = x.shape[-1]
    padded = torch.nn.functional.pad(x, (step, step))
    flat = padded.reshape(-1, padded.shape[-1])
    start = t_off.to(torch.int64) + step
    start = torch.where(start < 0, start + padded.shape[-1], start)
    start = torch.clamp(start, 0, 2 * step)
    start = torch.broadcast_to(start, x.shape[:-1]).reshape(-1, 1)
    idx = start + torch.arange(count, device=x.device)
    return torch.gather(flat, 1, idx).reshape(x.shape)


def _shifted_symbol_gather(x: torch.Tensor, total_symbols: int, n: int,
                           osr: int, t_off: torch.Tensor,
                           dec_phase: int = 0) -> torch.Tensor:
    """[..., S, N] decimated symbol windows with the reference's guarded
    per-symbol timing-offset shift (src/phy/LoRaDemod.cpp:141-149): a
    symbol uses the shifted window only when the shift stays in range,
    otherwise the unshifted one. ``dec_phase`` picks which of the ``osr``
    decimation phases to keep (see the JAX twin).

    The JAX twin's ``lax.cond(all(t_off == 0), ...)`` is a Python branch
    on one boolean read from the device: when every frame's offset is zero
    (the steady state, and the bench batch) the padded copy and the gather
    of :func:`_shifted_rows` are never made, which a guarded select would
    pay for in full on every call. The cost is one host sync per call
    (:func:`..utils.profiling.host_sync`): on a CUDA device the read waits
    for every op queued before it, whether or not an offset is zero.
    Semantics are identical: at ``t_off == 0`` the guard selects the
    unshifted window for every symbol."""
    step = n * osr
    sample_count = total_symbols * step
    x = x[..., :sample_count]

    def symview(a):
        return a.reshape(*a.shape[:-1], total_symbols, n, osr)[..., dec_phase]

    aligned = (t_off == 0).all()
    with host_sync():
        aligned = bool(aligned)
    if aligned:
        return symview(x)
    shifted = _shifted_rows(x, t_off, step)
    base = torch.arange(total_symbols, dtype=torch.int32, device=x.device) * step
    t = t_off[..., None].to(torch.int32)                   # [..., 1]
    use_shift = ((t > 0) & (base + t + step <= sample_count)) | (
        (t < 0) & (-t <= base)
    )                                                      # [..., S]
    return torch.where(use_shift[..., None], symview(shifted), symview(x))


def _sync_from_symbols(idx0: torch.Tensor, idx1: torch.Tensor, sf: int) -> torch.Tensor:
    """Recover the two-nibble sync byte (src/phy/LoRaDemod.cpp:177-192)."""
    shift = (sf - 4) if sf > 4 else 0
    hi = (idx0 >> shift) & 0x0F
    lo = (idx1 >> shift) & 0x0F
    return ((hi << 4) | lo).to(torch.uint8)
