"""The LoRa coding chains in plain NumPy, written from the reference
library's definitions (include/lora_phy/LoRaCodes.hpp, src/phy/
LoRaEncoder.cpp, LoRaDecoder.cpp) and not from the program's code.

Two chains:

* the simple chain (``encode_simple`` / ``decode_simple``): each byte as
  its high then low nibble, each nibble a Hamming(8,4) codeword, one
  codeword a symbol;
* the coded chain (``encode_coded`` / ``decode_coded``): payload, CRC16
  (SX1272) appended little-endian, whitened by the dual 64-bit LFSR at
  full byte width, nibbles, FEC by coding rate (4/5 parity or 4/8
  Hamming, the two rates the configurations use), diagonal interleaving
  over ``sf`` bit positions, Gray demapping into chirp bins.

Every function works on the last axis of an integer array and on any
leading shape.
"""

from __future__ import annotations

import functools

import numpy as np


def _bits(x, n):
    """LSB-first bits of ``x`` ([...] ints) -> [..., n] int64."""
    return (np.asarray(x, np.int64)[..., None] >> np.arange(n)) & 1


def _pack(bits):
    """LSB-first pack of [..., n] bits -> [...] int64."""
    return np.sum(bits << np.arange(bits.shape[-1]), axis=-1)


def nibbles(data):
    """[..., B] bytes -> [..., 2B] nibbles, high nibble first."""
    data = np.asarray(data, np.int64) & 0xFF
    return np.stack([data >> 4, data & 0xF], axis=-1).reshape(*data.shape[:-1], -1)


def join_nibbles(nib):
    """[..., 2B] nibbles -> [..., B] uint8 bytes."""
    nib = np.asarray(nib, np.int64).reshape(*np.shape(nib)[:-1], -1, 2) & 0xF
    return ((nib[..., 0] << 4) | nib[..., 1]).astype(np.uint8)


# ---------------------------------------------------------------------------
# FEC
# ---------------------------------------------------------------------------

def hamming84_encode(nib):
    """Data bits d0..d3 in bits 0..3, parities p0 = d0^d1^d2,
    p1 = d1^d2^d3, p2 = d0^d1^d3, p3 = d0^d2^d3 in bits 4..7."""
    d = _bits(nib, 4)
    p0 = d[..., 0] ^ d[..., 1] ^ d[..., 2]
    p1 = d[..., 1] ^ d[..., 2] ^ d[..., 3]
    p2 = d[..., 0] ^ d[..., 1] ^ d[..., 3]
    p3 = d[..., 0] ^ d[..., 2] ^ d[..., 3]
    return (np.asarray(nib, np.int64) & 0xF) | (p0 << 4) | (p1 << 5) | (p2 << 6) | (p3 << 7)


def hamming84_decode(cw):
    """(nibble, error) of [...] 8-bit codewords: the syndrome names the
    data bit to flip (one error in a data bit); a syndrome of one bit is a
    parity bit's error; any other nonzero syndrome leaves the data bits."""
    b = _bits(np.asarray(cw, np.int64) & 0xFF, 8)
    s = ((b[..., 0] ^ b[..., 1] ^ b[..., 2] ^ b[..., 4])
         | (b[..., 1] ^ b[..., 2] ^ b[..., 3] ^ b[..., 5]) << 1
         | (b[..., 0] ^ b[..., 1] ^ b[..., 3] ^ b[..., 6]) << 2
         | (b[..., 0] ^ b[..., 2] ^ b[..., 3] ^ b[..., 7]) << 3)
    flip = np.select([s == 0xD, s == 0x7, s == 0xB, s == 0xE], [1, 2, 4, 8], 0)
    return (np.asarray(cw, np.int64) & 0xF) ^ flip, s != 0


def parity54_encode(nib):
    """Four data bits and their even parity in bit 4."""
    nib = np.asarray(nib, np.int64) & 0xF
    return nib | (np.sum(_bits(nib, 4), axis=-1) & 1) << 4


def parity54_check(cw):
    """(nibble, error) of 5-bit codewords: error where the parity of all
    five bits is odd."""
    cw = np.asarray(cw, np.int64) & 0x1F
    return cw & 0xF, (np.sum(_bits(cw, 5), axis=-1) & 1) == 1


_FEC = {1: (parity54_encode, parity54_check), 4: (hamming84_encode, hamming84_decode)}


# ---------------------------------------------------------------------------
# Whitening, CRC, interleaving, Gray
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _whitening_stream(count: int = 512) -> np.ndarray:
    """Bytes of the SX1272 dual 64-bit LFSR whitening sequence (taps at
    bits 0, 16, 24, 32; two registers taking turns, one byte a step)."""
    regs = [0x6572D100E85C2EFF, 0xE85C2EFFFFFFFFFF]
    mask = (1 << 64) - 1
    out = np.zeros(count, np.uint8)
    for k in range(count):
        s = regs[k & 1]
        out[k] = s & 0xFF
        feedback = ((s >> 32) ^ (s >> 24) ^ (s >> 16) ^ s) & 0xFF
        regs[k & 1] = ((s >> 8) | (feedback << 56)) & mask
    return out


def whiten(data):
    """XOR of [..., B] bytes with the whitening sequence (an involution)."""
    data = np.asarray(data, np.uint8)
    return data ^ _whitening_stream()[: data.shape[-1]]


def _lfsr8(v: int) -> int:
    """One step of the CRC's 8-bit output-mask register (taps 0xB8)."""
    return ((bin(v & 0xB8).count("1") & 1) | (v << 1)) & 0xFF


def crc16_sx1272(data):
    """SX1272 payload CRC of [..., L] bytes: CCITT polynomial 0x1021 from
    0, each byte XORed in after a shift of the register by eight bits, and
    the result XORed with two bytes of an 8-bit LFSR mask started at 0xFF
    and stepped once a byte."""
    data = np.asarray(data, np.int64)
    res = np.zeros(data.shape[:-1], np.int64)
    v = 0xFF
    for i in range(data.shape[-1]):
        for _ in range(8):
            res = np.where(res & 0x8000, (res << 1) ^ 0x1021, res << 1) & 0xFFFF
        v = _lfsr8(v)
        res = res ^ data[..., i]
    res = res ^ v
    v = _lfsr8(v)
    return res ^ (v << 8)


def interleave(cw, ppm: int, nbits: int):
    """Diagonal interleaving of [..., blocks*ppm] codewords into
    [..., blocks*nbits] symbols: bit ``j`` of symbol ``i`` is bit ``i``
    of codeword ``(j + i) % ppm`` of its block."""
    cw = np.asarray(cw, np.int64)
    blk = cw.reshape(*cw.shape[:-1], -1, ppm)
    bits = _bits(blk, nbits)                                  # [..., blk, ppm, nbits]
    i = np.arange(nbits)[:, None]
    j = np.arange(ppm)[None, :]
    sym_bits = bits[..., (j + i) % ppm, i]                    # [..., blk, nbits, ppm]
    return _pack(sym_bits).reshape(*cw.shape[:-1], -1)


def deinterleave(sym, ppm: int, nbits: int):
    """Inverse of :func:`interleave`."""
    sym = np.asarray(sym, np.int64)
    blk = sym.reshape(*sym.shape[:-1], -1, nbits)
    bits = _bits(blk, ppm)                                    # [..., blk, nbits, ppm]
    d = np.arange(ppm)[:, None]
    i = np.arange(nbits)[None, :]
    cw_bits = bits[..., i, (d - i) % ppm]                     # [..., blk, ppm, nbits]
    return _pack(cw_bits).reshape(*sym.shape[:-1], -1)


def gray(x):
    """Binary -> reflected Gray code."""
    x = np.asarray(x, np.int64) & 0xFFFF
    return x ^ (x >> 1)


def ungray(g):
    """Reflected Gray code -> binary."""
    x = np.asarray(g, np.int64) & 0xFFFF
    for s in (8, 4, 2, 1):
        x = x ^ (x >> s)
    return x


# ---------------------------------------------------------------------------
# The two chains
# ---------------------------------------------------------------------------

def encode_simple(payload):
    """[..., B] bytes -> [..., 2B] symbols: one Hamming(8,4) codeword per
    nibble."""
    return hamming84_encode(nibbles(payload))


def decode_simple(symbols):
    """[..., 2B] symbols -> [..., B] bytes, each codeword corrected."""
    nib, _ = hamming84_decode(symbols)
    return join_nibbles(nib)


def coded_symbol_count(nbytes: int, sf: int, cr: int) -> int:
    """Payload symbols of ``nbytes`` bytes plus the CRC."""
    blocks = -(-2 * (nbytes + 2) // sf)
    return blocks * (4 + cr)


def encode_coded(payload, sf: int, cr: int):
    """[..., B] bytes -> [..., coded_symbol_count] chirp bins."""
    payload = np.asarray(payload, np.uint8)
    crc = crc16_sx1272(payload)
    framed = np.concatenate([payload, (crc & 0xFF)[..., None].astype(np.uint8),
                             (crc >> 8)[..., None].astype(np.uint8)], axis=-1)
    nib = nibbles(whiten(framed))
    pad = -nib.shape[-1] % sf
    nib = np.concatenate([nib, np.zeros((*nib.shape[:-1], pad), np.int64)], axis=-1)
    return ungray(interleave(_FEC[cr][0](nib), sf, 4 + cr))


def decode_coded(symbols, nbytes: int, sf: int, cr: int):
    """[..., S] chirp bins -> (payload [..., nbytes] uint8, crc_ok [...],
    fec_errors [...]: codewords whose check failed)."""
    cw = deinterleave(gray(symbols), sf, 4 + cr)
    nib, err = _FEC[cr][1](cw)
    framed = whiten(join_nibbles(nib[..., : 2 * (nbytes + 2)]))
    payload = framed[..., :nbytes]
    provided = framed[..., nbytes].astype(np.int64) | (framed[..., nbytes + 1].astype(np.int64) << 8)
    return payload, provided == crc16_sx1272(payload), np.sum(err, axis=-1)
