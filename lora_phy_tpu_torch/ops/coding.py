"""Bit-exact LoRa coding primitives on tensors — the main-path subset of
``lora_phy_tpu/ops/coding.py``: nibbles, Gray, Hamming 8/4 and the SX1272
CRC16 (everything ``modem.encode`` / ``decode`` / ``decode_with_crc`` use).

The LUTs are built by copies of the JAX module's NumPy builders, so they
are bit-equal by construction (the tests hold them so). Lookups are
``lut[idx]`` gathers on the input's device.

Integer types: torch's ``uint16`` has only partial bitwise support, so
symbol-valued results (Gray, CRC16) come back as ``int32`` where the JAX
twin gives ``uint16``; bytes and nibbles stay ``uint8``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device_table

__all__ = [
    "binary_to_gray",
    "gray_to_binary",
    "hamming84_encode",
    "hamming84_decode",
    "crc16_sx1272",
    "bytes_to_nibbles",
    "nibbles_to_bytes",
]


def bytes_to_nibbles(data: torch.Tensor) -> torch.Tensor:
    """Bytes -> interleaved (hi, lo) nibble stream, [..., B] -> [..., 2B]
    uint8 (reference: src/phy/LoRaEncoder.cpp:12-15)."""
    data = data.to(torch.int32) & 0xFF
    hi = (data >> 4) & 0x0F
    lo = data & 0x0F
    return torch.stack([hi, lo], dim=-1).reshape(*data.shape[:-1], -1).to(torch.uint8)


def nibbles_to_bytes(nibbles: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`bytes_to_nibbles` (reference: src/phy/LoRaDecoder.cpp:13-16)."""
    pairs = (nibbles.to(torch.int32) & 0xFF).reshape(*nibbles.shape[:-1], -1, 2)
    return (((pairs[..., 0] & 0x0F) << 4) | (pairs[..., 1] & 0x0F)).to(torch.uint8)


def binary_to_gray(num: torch.Tensor) -> torch.Tensor:
    """Reflected binary Gray code, 16-bit, as int32 (LoRaCodes.hpp:201-207)."""
    num = num.to(torch.int32) & 0xFFFF
    return num ^ (num >> 1)


def gray_to_binary(num: torch.Tensor) -> torch.Tensor:
    """Gray -> binary via a 4-step xor fold, 16-bit, as int32 (LoRaCodes.hpp:212-222)."""
    num = num.to(torch.int32) & 0xFFFF
    num = num ^ (num >> 8)
    num = num ^ (num >> 4)
    num = num ^ (num >> 2)
    num = num ^ (num >> 1)
    return num


# ---------------------------------------------------------------------------
# Hamming 8/4 LUTs (NumPy copies of the JAX builders)
# ---------------------------------------------------------------------------

def _bit(x, i):
    return (x >> i) & 1


def _build_hamming84_enc() -> np.ndarray:
    lut = np.zeros(16, dtype=np.uint8)
    for x in range(16):
        d0, d1, d2, d3 = _bit(x, 0), _bit(x, 1), _bit(x, 2), _bit(x, 3)
        b = x & 0xF
        b |= (d0 ^ d1 ^ d2) << 4
        b |= (d1 ^ d2 ^ d3) << 5
        b |= (d0 ^ d1 ^ d3) << 6
        b |= (d0 ^ d2 ^ d3) << 7
        lut[x] = b
    return lut


def _build_hamming84_dec() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """256-entry decode LUT -> (nibble, error, bad) per LoRaCodes.hpp:250-281."""
    nib = np.zeros(256, dtype=np.uint8)
    err = np.zeros(256, dtype=np.bool_)
    bad = np.zeros(256, dtype=np.bool_)
    for b in range(256):
        b0, b1, b2, b3 = _bit(b, 0), _bit(b, 1), _bit(b, 2), _bit(b, 3)
        b4, b5, b6, b7 = _bit(b, 4), _bit(b, 5), _bit(b, 6), _bit(b, 7)
        p0 = b0 ^ b1 ^ b2 ^ b4
        p1 = b1 ^ b2 ^ b3 ^ b5
        p2 = b0 ^ b1 ^ b3 ^ b6
        p3 = b0 ^ b2 ^ b3 ^ b7
        parity = (p0 << 0) | (p1 << 1) | (p2 << 2) | (p3 << 3)
        err[b] = parity != 0
        if parity == 0xD:
            nib[b] = (b ^ 1) & 0xF
        elif parity == 0x7:
            nib[b] = (b ^ 2) & 0xF
        elif parity == 0xB:
            nib[b] = (b ^ 4) & 0xF
        elif parity == 0xE:
            nib[b] = (b ^ 8) & 0xF
        elif parity in (0x0, 0x1, 0x2, 0x4, 0x8):
            nib[b] = b & 0xF
        else:
            bad[b] = True
            nib[b] = b & 0xF
    return nib, err, bad


_H84_ENC = _build_hamming84_enc()
_H84_DEC_NIB, _H84_DEC_ERR, _H84_DEC_BAD = _build_hamming84_dec()


def _h84_enc():
    return _H84_ENC


def _h84_dec():
    return _H84_DEC_NIB, _H84_DEC_ERR, _H84_DEC_BAD


def hamming84_encode(nibbles: torch.Tensor) -> torch.Tensor:
    """Hamming(8,4) SX-variant encode, uint8 (LoRaCodes.hpp:229-242)."""
    lut = device_table(_h84_enc, device=nibbles.device)
    return lut[nibbles.to(torch.int64) & 0xF]


def hamming84_decode(codewords: torch.Tensor):
    """Hamming(8,4) decode with single-error correction.

    Returns ``(nibbles uint8, error bool, bad bool)`` (LoRaCodes.hpp:250-281).
    """
    nib, err, bad = device_table(_h84_dec, device=codewords.device)
    cw = codewords.to(torch.int64) & 0xFF
    return nib[cw], err[cw], bad[cw]


# ---------------------------------------------------------------------------
# SX1272 CRC16 (reference: LoRaCodes.hpp:69-105)
# ---------------------------------------------------------------------------

def _crc16sx_step_table() -> np.ndarray:
    """256-entry table: running the high byte through 8 shift-xor rounds of
    poly 0x1021 with no data input (reference crc16sx, LoRaCodes.hpp:69-79)."""
    tab = np.zeros(256, dtype=np.uint32)
    for b in range(256):
        crc = b << 8
        for _ in range(8):
            if crc & 0x8000:
                crc = ((crc << 1) ^ 0x1021) & 0xFFFF
            else:
                crc = (crc << 1) & 0xFFFF
        tab[b] = crc
    return tab


def _xsum8(t: int) -> int:
    t ^= t >> 4
    t ^= t >> 2
    t ^= t >> 1
    return t & 1


def _build_v_sequence(n: int) -> np.ndarray:
    """Data-independent 8-bit LFSR mask sequence ``v`` in sx1272DataChecksum
    (reference: LoRaCodes.hpp:94-103). V[k] = value of v after k updates."""
    out = np.zeros(n, dtype=np.uint8)
    v = 0xFF
    for k in range(n):
        out[k] = v
        v = (_xsum8(v & 0xB8) | (v << 1)) & 0xFF
    return out


_CRC_STEP = _crc16sx_step_table()
_CRC_V = _build_v_sequence(600)

# Per-distance contribution LUTs: a data byte XOR'd into ``res`` at distance d
# from the end contributes A[d][byte] to the final pre-mask CRC (the step map
# is linear over GF(2), so contributions superpose).
_CRC_MAX_LEN = 256


def _build_crc_dist_tables() -> np.ndarray:
    A = np.zeros((_CRC_MAX_LEN, 256), dtype=np.uint16)
    A[0] = np.arange(256, dtype=np.uint16)  # distance 0: res ^= byte, final
    for d in range(1, _CRC_MAX_LEN):
        prev = A[d - 1].astype(np.uint32)
        A[d] = (((prev & 0xFF) << 8) ^ _CRC_STEP[prev >> 8]).astype(np.uint16)
    return A


_CRC_DIST = _build_crc_dist_tables()


def _crc_dist_i32():
    return _CRC_DIST.astype(np.int32)


def crc16_sx1272(data: torch.Tensor) -> torch.Tensor:
    """SX1272 payload CRC16 as int32: modified CCITT with an 8-bit LFSR
    output mask (reference: LoRaCodes.hpp:92-105). ``data`` is [..., L]
    bytes with L <= 255.

    The XOR-reduction of per-position GF(2) tables: byte i sits at
    distance L-1-i from the end and contributes ``A[L-1-i, data[i]]``.
    The JAX twin decomposes that pick over the byte's bits to avoid an
    element gather on its chip; here it is the plain gather."""
    L = data.shape[-1]
    if L == 0:
        # Reference loop body never runs: res = 0 ^ V[0] ^ (V[1] << 8)
        return torch.tensor(int(_CRC_V[0]) ^ (int(_CRC_V[1]) << 8),
                            dtype=torch.int32, device=data.device)
    if L >= _CRC_MAX_LEN:
        raise ValueError(f"payload too long for CRC table ({L} >= {_CRC_MAX_LEN})")
    table = device_table(_crc_dist_i32, device=data.device)     # [256, 256]
    dist = torch.arange(L - 1, -1, -1, device=data.device)      # [L]
    contrib = table[dist, data.to(torch.int64) & 0xFF]           # [..., L]
    mask = int(_CRC_V[L]) ^ (int(_CRC_V[L + 1]) << 8)
    return _xor_reduce(contrib) ^ mask


def _xor_reduce(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """XOR-reduce along ``dim`` via a log-depth halving tree."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = torch.cat([x[..., :half] ^ x[..., half:2 * half],
                       x[..., 2 * half:]], dim=-1)
    return x[..., 0]
