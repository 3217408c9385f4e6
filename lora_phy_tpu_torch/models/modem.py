"""High-level LoRa modem on tensors — the PyTorch twin of
``lora_phy_tpu/models/modem.py`` (main path).

``encode`` / ``decode`` / ``decode_with_crc`` are the simple Hamming 8/4
chain. ``modulate`` / ``dechirp`` / ``demodulate`` are the complex64 API,
written as thin wrappers over the planar pipeline in
:mod:`..ops.planar` (on CUDA complex64 is native, so there is no second
pipeline to keep equal). The private helpers below are the ones the
planar demodulator shares with this module in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import LoraParams, Window, device_of
from ..ops import coding


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
    (reference: src/phy/LoRaDecoder.cpp:6-19). [..., 2B] -> [..., B] uint8."""
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
               known_offsets=None) -> DemodResult:
    """Demodulate already-dechirped complex64 samples — the reference's
    working contract (``lora_demodulate``, src/phy/LoRaDemod.cpp:49-195).

    ``samples``: [..., S_total*step] (S_total >= 2; the first two symbols
    are the sync word). Returns data symbols [..., S_total-2] (int32), the
    sync byte and the CFO/TO estimates. ``known_offsets=(cfo, time_offset)``
    bypasses the 2-symbol estimator. The JAX twin's ``backend=`` (its FFT
    choice) has no counterpart: the port always runs the planar DFT."""
    from ..ops.planar import demodulate_planar, split_complex

    res = demodulate_planar(*split_complex(samples), params,
                            known_offsets=known_offsets)
    return DemodResult(*res)


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


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """std::round semantics (half away from zero) — torch.round is half-even."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


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
    pay for in full on every call. The cost is one device-to-host read
    per call. Semantics are identical: at ``t_off == 0`` the guard selects
    the unshifted window for every symbol."""
    step = n * osr
    sample_count = total_symbols * step
    x = x[..., :sample_count]

    def symview(a):
        return a.reshape(*a.shape[:-1], total_symbols, n, osr)[..., dec_phase]

    if bool((t_off == 0).all()):
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
