"""Bit-exact LoRa coding primitives on tensors — the PyTorch twin of
``lora_phy_tpu/ops/coding.py``, function for function: bit pack/unpack,
nibbles, Gray, Hamming 8/4 and 7/4, parity 5/4 and 6/4, the three
whiteners, the SX1272 CRC16, the header checksum and checksum8, and the
diagonal (de)interleavers (reference: include/lora_phy/LoRaCodes.hpp).

The LUTs, keystreams and interleaver maps are built by copies of the JAX
module's NumPy builders, so they are bit-equal by construction (the
tests hold them so). Lookups are ``lut[idx]`` gathers on the input's
device.

Integer types: torch's ``uint16`` has only partial bitwise support, so
symbol-valued results (Gray, CRC16, interleaved symbols, packed bits)
come back as ``int32`` where the JAX twin gives ``uint16``; bytes,
nibbles and codewords stay ``uint8``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import device_table

__all__ = [
    "binary_to_gray",
    "gray_to_binary",
    "hamming84_encode",
    "hamming84_decode",
    "hamming74_encode",
    "hamming74_decode",
    "parity54_encode",
    "parity54_check",
    "parity64_encode",
    "parity64_check",
    "whiten_sx1232",
    "whiten_sx1272_seq",
    "whiten_sx1272_lfsr",
    "crc16_sx1272",
    "header_checksum",
    "checksum8",
    "diagonal_interleave",
    "diagonal_deinterleave",
    "diagonal_deinterleave_v2",
    "bytes_to_nibbles",
    "nibbles_to_bytes",
    "unpack_bits",
    "pack_bits",
]


# ---------------------------------------------------------------------------
# Bit helpers (LSB-first)
# ---------------------------------------------------------------------------

def unpack_bits(x: torch.Tensor, nbits: int) -> torch.Tensor:
    """LSB-first bit unpack: [...] ints -> [..., nbits] in {0, 1}, in the
    dtype of ``x``."""
    shifts = torch.arange(nbits, dtype=x.dtype, device=x.device)
    return (x[..., None] >> shifts) & 1


def pack_bits(bits: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """LSB-first bit pack: [..., nbits] -> [...] ints (JAX's default
    dtype is uint16; the port's is int32)."""
    nbits = bits.shape[-1]
    shifts = torch.arange(nbits, dtype=torch.int64, device=bits.device)
    return torch.sum(bits.to(torch.int64) << shifts, dim=-1).to(dtype)


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


def _take(builder, idx: torch.Tensor, *args):
    """``builder(*args)``'s NumPy LUT, uploaded once, gathered at ``idx``."""
    return device_table(builder, *args, device=idx.device)[idx.to(torch.int64)]


# ---------------------------------------------------------------------------
# Gray code (reference: LoRaCodes.hpp:201-222)
# ---------------------------------------------------------------------------

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
# Hamming / parity LUTs (NumPy copies of the JAX builders)
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


def _build_hamming74_enc() -> np.ndarray:
    lut = np.zeros(16, dtype=np.uint8)
    for x in range(16):
        d0, d1, d2, d3 = _bit(x, 0), _bit(x, 1), _bit(x, 2), _bit(x, 3)
        b = x & 0xF
        b |= (d0 ^ d1 ^ d2) << 4
        b |= (d1 ^ d2 ^ d3) << 5
        b |= (d0 ^ d1 ^ d3) << 6
        lut[x] = b
    return lut


def _build_hamming74_dec() -> tuple[np.ndarray, np.ndarray]:
    """128-entry decode LUT -> (nibble, error) per LoRaCodes.hpp:306-334."""
    nib = np.zeros(128, dtype=np.uint8)
    err = np.zeros(128, dtype=np.bool_)
    for b in range(128):
        b0, b1, b2, b3 = _bit(b, 0), _bit(b, 1), _bit(b, 2), _bit(b, 3)
        b4, b5, b6 = _bit(b, 4), _bit(b, 5), _bit(b, 6)
        p0 = b0 ^ b1 ^ b2 ^ b4
        p1 = b1 ^ b2 ^ b3 ^ b5
        p2 = b0 ^ b1 ^ b3 ^ b6
        parity = (p0 << 0) | (p1 << 1) | (p2 << 2)
        err[b] = parity != 0
        if parity == 0x5:
            nib[b] = (b ^ 1) & 0xF
        elif parity == 0x7:
            nib[b] = (b ^ 2) & 0xF
        elif parity == 0x3:
            nib[b] = (b ^ 4) & 0xF
        elif parity == 0x6:
            nib[b] = (b ^ 8) & 0xF
        else:
            nib[b] = b & 0xF
    return nib, err


def _build_parity54() -> tuple[np.ndarray, np.ndarray]:
    """(encode LUT[16], check-error LUT[32]) per LoRaCodes.hpp:340-351."""
    enc = np.zeros(16, dtype=np.uint8)
    for b in range(16):
        x = b ^ (b >> 2)
        x = x ^ (x >> 1)
        enc[b] = (b & 0xF) | ((x << 4) & 0x10)
    chk_err = np.zeros(32, dtype=np.bool_)
    for b in range(32):
        x = b ^ (b >> 2)
        x = x ^ (x >> 1) ^ (b >> 4)
        chk_err[b] = bool(x & 1)
    return enc, chk_err


def _build_parity64() -> tuple[np.ndarray, np.ndarray]:
    """(encode LUT[16], check-error LUT[64]) per LoRaCodes.hpp:357-371."""
    enc = np.zeros(16, dtype=np.uint8)
    for b in range(16):
        x = b ^ (b >> 1) ^ (b >> 2)
        y = x ^ b ^ (b >> 3)
        enc[b] = ((x & 1) << 4) | ((y & 1) << 5) | (b & 0xF)
    chk_err = np.zeros(64, dtype=np.bool_)
    for b in range(64):
        x = b ^ (b >> 1) ^ (b >> 2)
        y = x ^ b ^ (b >> 3)
        x ^= b >> 4
        y ^= b >> 5
        chk_err[b] = bool((x | y) & 1)
    return enc, chk_err


_H84_ENC = _build_hamming84_enc()
_H84_DEC_NIB, _H84_DEC_ERR, _H84_DEC_BAD = _build_hamming84_dec()
_H74_ENC = _build_hamming74_enc()
_H74_DEC_NIB, _H74_DEC_ERR = _build_hamming74_dec()
_P54_ENC, _P54_CHK_ERR = _build_parity54()
_P64_ENC, _P64_CHK_ERR = _build_parity64()


def _h84_enc():
    return _H84_ENC


def _h84_dec():
    return _H84_DEC_NIB, _H84_DEC_ERR, _H84_DEC_BAD


def _h74_enc():
    return _H74_ENC


def _h74_dec():
    return _H74_DEC_NIB, _H74_DEC_ERR


def _p54_enc():
    return _P54_ENC


def _p54_err():
    return _P54_CHK_ERR


def _p64_enc():
    return _P64_ENC


def _p64_err():
    return _P64_CHK_ERR


def hamming84_encode(nibbles: torch.Tensor) -> torch.Tensor:
    """Hamming(8,4) SX-variant encode, uint8 (LoRaCodes.hpp:229-242)."""
    return _take(_h84_enc, nibbles.to(torch.int64) & 0xF)


def hamming84_decode(codewords: torch.Tensor):
    """Hamming(8,4) decode with single-error correction.

    Returns ``(nibbles uint8, error bool, bad bool)`` (LoRaCodes.hpp:250-281).
    """
    nib, err, bad = device_table(_h84_dec, device=codewords.device)
    cw = codewords.to(torch.int64) & 0xFF
    return nib[cw], err[cw], bad[cw]


def hamming74_encode(nibbles: torch.Tensor) -> torch.Tensor:
    """Hamming(7,4) SX-variant encode, uint8 (LoRaCodes.hpp:287-299)."""
    return _take(_h74_enc, nibbles.to(torch.int64) & 0xF)


def hamming74_decode(codewords: torch.Tensor):
    """Hamming(7,4) decode. Returns ``(nibbles uint8, error bool)``
    (LoRaCodes.hpp:306-334)."""
    nib, err = device_table(_h74_dec, device=codewords.device)
    cw = codewords.to(torch.int64) & 0x7F
    return nib[cw], err[cw]


def parity54_encode(nibbles: torch.Tensor) -> torch.Tensor:
    """5/4 single-parity encode, uint8 (LoRaCodes.hpp:347-351)."""
    return _take(_p54_enc, nibbles.to(torch.int64) & 0xF)


def parity54_check(codewords: torch.Tensor):
    """5/4 parity check. Returns ``(nibbles uint8, error bool)``
    (LoRaCodes.hpp:340-345)."""
    cw = codewords.to(torch.int64) & 0x1F
    return (cw & 0xF).to(torch.uint8), _take(_p54_err, cw)


def parity64_encode(nibbles: torch.Tensor) -> torch.Tensor:
    """6/4 double-parity encode, uint8 (LoRaCodes.hpp:367-371)."""
    return _take(_p64_enc, nibbles.to(torch.int64) & 0xF)


def parity64_check(codewords: torch.Tensor):
    """6/4 parity check. Returns ``(nibbles uint8, error bool)``
    (LoRaCodes.hpp:357-365)."""
    cw = codewords.to(torch.int64) & 0x3F
    return (cw & 0xF).to(torch.uint8), _take(_p64_err, cw)


# ---------------------------------------------------------------------------
# Whitening keystreams (NumPy copies of the JAX builders;
# reference: LoRaCodes.hpp:111-189)
# ---------------------------------------------------------------------------

_WHITEN_MAX = 4096  # longest supported whitening run, in bytes


def _build_sx1232_stream(n: int) -> np.ndarray:
    """Semtech AN1200.18 LFSR x^9+x^5+1 seed 0x1FF keystream
    (reference: LoRaCodes.hpp:111-137). Output byte j is the LSB byte of the
    LFSR state before the 8-bit shift for byte j."""
    out = np.zeros(n, dtype=np.uint8)
    msb, lsb = 0x01, 0xFF
    for j in range(n):
        out[j] = lsb
        for _ in range(8):
            msb_prev = msb
            msb = (lsb & 0x01) ^ ((lsb >> 5) & 0x01)
            lsb = ((lsb >> 1) & 0xFF) | ((msb_prev << 7) & 0x80)
    return out


def _build_sx1272_seq_bits() -> np.ndarray:
    """The 510-bit whitening sequence table (reference: LoRaCodes.hpp:150-154)."""
    whiten_seq = np.array(
        [
            0x0102291EA751AAFF, 0xD24B050A8D643A17, 0x5B279B671120B8F4,
            0x032B37B9F6FB55A2, 0x994E0F87E95E2D16, 0x7CBCFC7631984C26,
            0x281C8E4F0DAEF7F9, 0x1741886EB7733B15,
        ],
        dtype=np.uint64,
    )
    t = np.arange(512, dtype=np.uint64)
    bits = (whiten_seq[(t >> np.uint64(6)).astype(int)] >> (t & np.uint64(0x3F))) & np.uint64(1)
    return bits[:510].astype(np.uint8)


def _build_sx1272_lfsr_stream(rdd_is_one: bool, n: int) -> np.ndarray:
    """Interleaved dual 64-bit LFSR keystream, poly 0x1D
    (reference: LoRaCodes.hpp:176-189). Entry k is the byte consumed at
    global step k (before masking with ``0xff >> (4 - RDD)``)."""
    if rdd_is_one:
        r = [0x05121100F8ECFEEF, 0xF8ECFEEFEFEFEFEF]
    else:
        r = [0x6572D100E85C2EFF, 0xE85C2EFFFFFFFFFF]
    mask64 = (1 << 64) - 1
    out = np.zeros(n, dtype=np.uint8)
    for k in range(n):
        s = r[k & 1]
        out[k] = s & 0xFF
        r[k & 1] = ((s >> 8) | ((((s >> 32) ^ (s >> 24) ^ (s >> 16) ^ s) << 56) & mask64)) & mask64
    return out


_SX1272_OFS0 = np.array([6, 4, 2, 0, -112, -114, -302, -34], dtype=np.int64)
_SX1272_OFS1 = np.array([6, 4, 2, 0, -360], dtype=np.int64)


@functools.lru_cache(maxsize=1)
def _sx1232_stream() -> np.ndarray:
    return _build_sx1232_stream(_WHITEN_MAX)


@functools.lru_cache(maxsize=1)
def _sx1272_seq_bits() -> np.ndarray:
    return _build_sx1272_seq_bits()


@functools.lru_cache(maxsize=2)
def _sx1272_lfsr_stream(rdd_is_one: bool) -> np.ndarray:
    return _build_sx1272_lfsr_stream(rdd_is_one, _WHITEN_MAX)


def whiten_sx1232(data: torch.Tensor) -> torch.Tensor:
    """SX1232/AN1200.18 whitening: XOR with the documented LFSR keystream
    (reference: LoRaCodes.hpp:111-137). Involutive — apply twice to undo."""
    data = data.to(torch.uint8)
    n = data.shape[-1]
    if n > _WHITEN_MAX:
        raise ValueError(f"whitening run too long ({n} > {_WHITEN_MAX})")
    return data ^ device_table(_sx1232_stream, device=data.device)[:n]


@functools.lru_cache(maxsize=64)
def _sx1272_seq_keystream(n: int, bit_ofs: int, rdd: int) -> np.ndarray:
    ofs = _SX1272_OFS1 if rdd == 1 else _SX1272_OFS0
    nbits = 4 + rdd
    j = np.arange(n, dtype=np.int64)
    # x[j] bit i = whiten_seq[(ofs[i] + j + bitOfs) mod 510]
    t = (ofs[:nbits, None] + j[None, :] + bit_ofs + 510) % 510
    bits = _sx1272_seq_bits()[t]  # [nbits, n]
    return np.sum(bits.astype(np.uint16) << np.arange(nbits, dtype=np.uint16)[:, None], axis=0).astype(np.uint8)


def whiten_sx1272_seq(data: torch.Tensor, bit_ofs: int = 0, rdd: int = 4) -> torch.Tensor:
    """Sequence-table SX1272 whitening (reference: LoRaCodes.hpp:147-167)."""
    data = data.to(torch.uint8)
    ks = device_table(_sx1272_seq_keystream, int(data.shape[-1]), int(bit_ofs),
                      int(rdd), device=data.device)
    return data ^ ks


def _sx1272_lfsr_masked(rdd: int) -> np.ndarray:
    """The whole precomputed LFSR keystream under ``0xff >> (4 - rdd)``."""
    return (_sx1272_lfsr_stream(rdd == 1) & (0xFF >> (4 - rdd))).astype(np.uint8)


def _sx1272_lfsr_keystream(n: int, bit_ofs: int, rdd: int) -> np.ndarray:
    """Keystream bytes ``bit_ofs .. bit_ofs + n`` past the precomputed
    stream's end: built anew, as the JAX twin does."""
    stream = _build_sx1272_lfsr_stream(rdd == 1, bit_ofs + n)
    return (stream[bit_ofs:bit_ofs + n] & (0xFF >> (4 - rdd))).astype(np.uint8)


def whiten_sx1272_lfsr(data: torch.Tensor, bit_ofs: int = 0, rdd: int = 4) -> torch.Tensor:
    """Dual-LFSR SX1272 whitening — the variant exercised by the reference's
    whitening test (reference: LoRaCodes.hpp:176-189, tests/whitening_test.cpp:38-43).
    Involutive. The keystream within the precomputed 4096 bytes is one
    table uploaded per device and sliced."""
    data = data.to(torch.uint8)
    n, bit_ofs, rdd = int(data.shape[-1]), int(bit_ofs), int(rdd)
    if bit_ofs + n <= _WHITEN_MAX:
        ks = device_table(_sx1272_lfsr_masked, rdd, device=data.device)[bit_ofs:bit_ofs + n]
    else:
        ks = torch.from_numpy(_sx1272_lfsr_keystream(n, bit_ofs, rdd)).to(data.device)
    return data ^ ks


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


def header_checksum(h: torch.Tensor) -> torch.Tensor:
    """5-bit explicit-header checksum over 2 header bytes, uint8
    (reference: LoRaCodes.hpp:43-67). ``h`` is [..., 2] bytes."""
    h = h.to(torch.int32) & 0xFF
    h0, h1 = h[..., 0], h[..., 1]
    a = [(h0 >> (4 + i)) & 1 for i in range(4)]
    b = [(h0 >> i) & 1 for i in range(4)]
    c = [(h1 >> i) & 1 for i in range(4)]
    res = (a[0] ^ a[1] ^ a[2] ^ a[3]) << 4
    res = res | ((a[3] ^ b[1] ^ b[2] ^ b[3] ^ c[0]) << 3)
    res = res | ((a[2] ^ b[0] ^ b[3] ^ c[1] ^ c[3]) << 2)
    res = res | ((a[1] ^ b[0] ^ b[2] ^ c[0] ^ c[1] ^ c[2]) << 1)
    res = res | (a[0] ^ b[1] ^ c[0] ^ c[1] ^ c[2] ^ c[3])
    return res.to(torch.uint8)


def checksum8(data) -> np.uint8:
    """Rotate-add 8-bit checksum (reference: LoRaCodes.hpp:32-41).

    The rotate-add recurrence carries through addition, so it is evaluated
    as a host loop (a tiny non-hot utility, as in the JAX twin); a tensor
    is read to the host first."""
    if isinstance(data, torch.Tensor):
        data = data.cpu().numpy()
    arr = np.asarray(data, dtype=np.uint8).reshape(-1)
    acc = 0
    for byte in arr:
        acc = ((acc >> 1) + ((acc & 0x1) << 7)) & 0xFF
        acc = (acc + int(byte)) & 0xFF
    return np.uint8(acc)


# ---------------------------------------------------------------------------
# Diagonal interleaver / deinterleaver (reference: LoRaCodes.hpp:376-432)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _interleave_map(ppm: int, rdd: int) -> np.ndarray:
    """Flat bit-gather map for the interleaver.

    Input bits are codeword-major: ``in[cw*nbits + bit]``. Output symbol bit
    ``(sym=bit, bitpos=cw)`` takes input bit ``bit`` of codeword
    ``(cw+bit) % ppm`` (LoRaCodes.hpp:383-390).
    Returns [nbits*ppm] int32 (symbol-major: ``out[sym*ppm + bitpos]``).
    """
    nbits = 4 + rdd
    bit = np.arange(nbits)[:, None]
    cw = np.arange(ppm)[None, :]
    return (((cw + bit) % ppm) * nbits + bit).reshape(-1).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _deinterleave_map(ppm: int, rdd: int) -> np.ndarray:
    """Inverse flat map: codeword bit ``(dst, bit)`` comes from symbol ``bit``
    at bit position ``(dst - bit) mod ppm`` (LoRaCodes.hpp:401-411).
    Input bits are symbol-major ``in[sym*ppm + bitpos]``; output is
    codeword-major ``out[dst*nbits + bit]``.
    """
    nbits = 4 + rdd
    dst = np.arange(ppm)[:, None]
    bit = np.arange(nbits)[None, :]
    return (bit * ppm + ((dst - bit) % ppm)).reshape(-1).astype(np.int32)


def _map_i64(builder, *args) -> np.ndarray:
    """An interleaver map as int64 (torch indexes with int64)."""
    return builder(*args).astype(np.int64)


def diagonal_interleave(codewords: torch.Tensor, ppm: int, rdd: int) -> torch.Tensor:
    """Diagonal interleave: [..., blocks*PPM] codewords -> [..., blocks*(4+RDD)]
    int32 symbols (reference: LoRaCodes.hpp:376-393). LSB-first bit order."""
    nbits = 4 + rdd
    nblk = codewords.shape[-1] // ppm
    cws = codewords[..., : nblk * ppm].reshape(*codewords.shape[:-1], nblk, ppm)
    bits = unpack_bits(cws.to(torch.int32), nbits)          # [..., blk, ppm, nbits]
    flat = bits.reshape(*bits.shape[:-2], ppm * nbits)
    sel = flat[..., device_table(_map_i64, _interleave_map, ppm, rdd,
                                 device=flat.device)]
    syms = pack_bits(sel.reshape(*sel.shape[:-1], nbits, ppm), dtype=torch.int32)
    return syms.reshape(*syms.shape[:-2], nblk * nbits)


def diagonal_deinterleave(symbols: torch.Tensor, ppm: int, rdd: int) -> torch.Tensor:
    """Exact inverse of :func:`diagonal_interleave`
    (reference: LoRaCodes.hpp:396-412). [..., blocks*(4+RDD)] symbols ->
    [..., blocks*PPM] uint8 codewords."""
    nbits = 4 + rdd
    nblk = symbols.shape[-1] // nbits
    syms = symbols[..., : nblk * nbits].reshape(*symbols.shape[:-1], nblk, nbits)
    bits = unpack_bits(syms.to(torch.int32), ppm)            # [..., blk, nbits, ppm]
    flat = bits.reshape(*bits.shape[:-2], nbits * ppm)
    sel = flat[..., device_table(_map_i64, _deinterleave_map, ppm, rdd,
                                 device=flat.device)]
    cws = pack_bits(sel.reshape(*sel.shape[:-1], ppm, nbits), dtype=torch.uint8)
    return cws.reshape(*cws.shape[:-2], nblk * ppm)


@functools.lru_cache(maxsize=64)
def _deinterleave_v2_map(ppm: int, rdd: int, nblk: int) -> tuple[np.ndarray, np.ndarray]:
    """Flat global map for the reference's "optimised" deinterleaver
    (LoRaCodes.hpp:415-432): per block, for m in [0, PPM) it reads
    ``symbols[symOff + m]`` — when PPM > 4+RDD this *spills into the next
    block's symbols* (and past the array on the final block, which is
    undefined behaviour upstream; we zero those bits instead of cloning UB).

    Output codeword bit (blk, i=(m+k)%ppm, bitpos=m) = bit k of
    ``symbols[blk*nb + m]``. Returns (gather [nblk*ppm*ppm] into the flat
    symbol-bit array [nblk*nb*ppm], valid mask).
    """
    nb = 4 + rdd
    total_syms = nblk * nb
    blk = np.arange(nblk)[:, None, None]
    m = np.arange(ppm)[None, :, None]
    k = np.arange(ppm)[None, None, :]
    sym_index = blk * nb + m                                  # global symbol read
    src = sym_index * ppm + k                                 # flat symbol-bit index
    valid = np.broadcast_to(sym_index < total_syms, src.shape)
    # destination: (blk, cw=(m+k)%ppm, bitpos=m)
    dst = (blk * ppm + (m + k) % ppm) * ppm + m
    gather = np.full(nblk * ppm * ppm, 0, dtype=np.int32)
    mask = np.zeros(nblk * ppm * ppm, dtype=bool)
    gather[dst.reshape(-1)] = np.where(valid, src, 0).reshape(-1)
    mask[dst.reshape(-1)] = valid.reshape(-1)
    return gather, mask


def _v2_tables(ppm: int, rdd: int, nblk: int):
    gather, mask = _deinterleave_v2_map(ppm, rdd, nblk)
    return gather.astype(np.int64), mask.astype(np.int32)


def diagonal_deinterleave_v2(symbols: torch.Tensor, ppm: int, rdd: int) -> torch.Tensor:
    """The reference's "optimised" deinterleaver variant with rotated,
    block-spilling addressing (reference: LoRaCodes.hpp:415-432), kept for
    API parity; uint8 codewords. Bit-exact wherever the reference's reads
    are in bounds."""
    nb = 4 + rdd
    nblk = symbols.shape[-1] // nb
    syms = symbols[..., : nblk * nb]
    bits = unpack_bits(syms.to(torch.int32), ppm)             # [..., nblk*nb, ppm]
    flat = bits.reshape(*bits.shape[:-2], nblk * nb * ppm)
    gather, mask = device_table(_v2_tables, ppm, rdd, nblk, device=flat.device)
    sel = flat[..., gather] * mask
    return pack_bits(sel.reshape(*sel.shape[:-1], nblk * ppm, ppm), dtype=torch.uint8)
