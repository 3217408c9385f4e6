"""High-level LoRa modem on tensors — the PyTorch twin of
``lora_phy_tpu/models/modem.py``.

``encode`` / ``decode`` / ``decode_with_crc`` are the simple Hamming 8/4
chain. The complex64 API (``modulate``, ``dechirp``, ``demodulate``,
``demodulate_integrated`` and the estimate / compensate functions of
phy.cpp) is written as thin wrappers over the planar pipeline in
:mod:`..ops.planar` (on CUDA complex64 is native, so there is no second
pipeline to keep equal).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import LoraParams, device_of, device_table
from ..ops import chirp, coding, planar, windows
from ..utils.profiling import stage_range


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
    return torch.complex(*planar.modulate_planar(symbols, params, amplitude))


def dechirp(iq: torch.Tensor, params: LoraParams) -> torch.Tensor:
    """External dechirp: multiply every symbol period by the base downchirp,
    the working-path contract (reference: tests/e2e_chain_test.cpp:80-93)."""
    return torch.complex(*planar.dechirp_planar(iq.real, iq.imag, params))


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
    _check_backend(backend)
    res = planar.demodulate_planar(*planar.split_complex(samples), params,
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
    return planar.estimate_offsets_planar(*planar.split_complex(samples), params)


def compensate_offsets(samples: torch.Tensor, params: LoraParams, cfo,
                       time_offset) -> torch.Tensor:
    """Derotate by the estimated CFO and shift by the integer timing offset
    with zero fill (reference: src/phy/phy.cpp:147-176): a complex64
    wrapper over :func:`..ops.planar.compensate_offsets_planar`."""
    return torch.complex(*planar.compensate_offsets_planar(
        samples.real, samples.imag, params, cfo, time_offset))


def estimate_sro(samples: torch.Tensor, params: LoraParams) -> torch.Tensor:
    """Sample-rate-offset (clock-drift) estimate in ppm from DECHIRPED
    symbol windows — a complex64 wrapper over
    :func:`..ops.planar.estimate_sro_planar` (see there for the method)."""
    return planar.estimate_sro_planar(samples.real.to(torch.float32),
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
    _check_backend(backend)
    n, osr, step = params.n, params.osr, params.step
    total_symbols = iq.shape[-1] // step
    if total_symbols < 2:
        raise ValueError("need at least the 2 sync symbols")
    xr, xi = planar.split_complex(iq[..., : total_symbols * step])
    er, ei = xr[..., : 2 * step], xi[..., : 2 * step]
    if not quirk_compat:
        er, ei = planar.dechirp_planar(er, ei, params)
    cfo, time_offset = planar.estimate_offsets_planar(er, ei, params)
    t_off = planar._round_half_away(time_offset).to(torch.int32)
    rate = -planar._TWO_PI_F32 * cfo / float(n)
    yr, yi = windows.shifted_windows(xr, xi, total_symbols, n, osr, t_off)  # [..., S, N]
    # dechirp by the osr-1 base downchirp (phy.cpp:203, 221)
    dr, di = device_table(chirp.base_downchirp_planar, params.sf, params.scale, 1,
                          device=xr.device)
    yr, yi = yr * dr - yi * di, yr * di + yi * dr
    fr, fi = planar._rotated_windows_planar(yr, yi, rate, t_off, None, params)
    syms = planar.argmax_bins_planar(fr, fi, n)
    sync = planar._sync_from_symbols(syms[..., 0], syms[..., 1], params.sf)
    return DemodResult(syms[..., 2:], sync, cfo, time_offset)
