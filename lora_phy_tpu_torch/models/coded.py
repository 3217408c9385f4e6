"""Full coded LoRa chain on tensors — the PyTorch twin of
``lora_phy_tpu/models/coded.py``: whitening + FEC + diagonal interleaving
+ Gray mapping + CRC framing, batched, and the explicit header.

TX:  payload -> [CRC16 append] -> whiten (Sx1272 LFSR, full width)
     -> nibbles -> FEC (parity54/64 | Hamming74/84 by CR)
     -> diagonal interleave (PPM = sf, or sf-2 with LDRO)
     -> Gray demap (bin = grayToBinary(word)) -> chirp bins
RX:  exact inverse, with single-error correction for CR 4/7, 4/8 and
     CRC verification.

Symbols are int32 where the JAX twin has uint16. Every place where JAX
relies on the uint16 wrap is masked to 16 bits here, so both packages
give the same bins for every input (the tests check every bin 0..N-1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device_of
from ..ops import coding

@dataclasses.dataclass(frozen=True)
class CodedConfig:
    """Static coded-chain options (gr-lora_sdr capture naming convention:
    ``bw_125k_sf_7_cr_1_ldro_false_crc_true_implheader_false``)."""

    sf: int = 7
    cr: int = 1          # 1..4 -> CR 4/5..4/8 (RDD index)
    ldro: bool = False   # low-data-rate optimisation: PPM = sf-2, bins << 2
    crc: bool = True     # append/verify trailing CRC16
    whiten: bool = True  # Sx1272 LFSR whitening over the payload bytes

    @property
    def ppm(self) -> int:
        return self.sf - 2 if self.ldro else self.sf

    @property
    def rdd(self) -> int:
        return self.cr

    @property
    def bits_per_symbol(self) -> int:
        return self.ppm


def _fec_encode(nibbles: torch.Tensor, cr: int) -> torch.Tensor:
    if cr == 1:
        return coding.parity54_encode(nibbles)
    if cr == 2:
        return coding.parity64_encode(nibbles)
    if cr == 3:
        return coding.hamming74_encode(nibbles)
    if cr == 4:
        return coding.hamming84_encode(nibbles)
    raise ValueError(f"cr must be 1..4, got {cr}")


def _fec_decode(codewords: torch.Tensor, cr: int):
    """Returns (nibbles, error_flag)."""
    if cr == 1:
        return coding.parity54_check(codewords)
    if cr == 2:
        return coding.parity64_check(codewords)
    if cr == 3:
        return coding.hamming74_decode(codewords)
    if cr == 4:
        nib, err, _ = coding.hamming84_decode(codewords)
        return nib, err
    raise ValueError(f"cr must be 1..4, got {cr}")


def payload_symbol_count(nbytes: int, cfg: CodedConfig) -> int:
    """Symbols needed for ``nbytes`` payload (+CRC if enabled)."""
    total = nbytes + (2 if cfg.crc else 0)
    nibbles = total * 2
    blocks = -(-nibbles // cfg.ppm)
    return blocks * (4 + cfg.rdd)


def encode_payload(payload, cfg: CodedConfig, device=None) -> torch.Tensor:
    """[..., B] payload bytes -> [..., S] chirp-bin symbols (int32; the
    JAX twin returns uint16).

    ``payload`` is a tensor, computed on where it lives, or an array of
    bytes together with ``device=``. Pads the nibble stream with zeros to
    a whole interleaver block, exactly invertible by :func:`decode_payload`
    given ``B``."""
    payload = torch.as_tensor(payload, device=device_of(payload, device)).to(torch.uint8)
    framed = payload
    if cfg.crc:
        crc = coding.crc16_sx1272(payload).expand(payload.shape[:-1])
        framed = torch.cat([payload, (crc & 0xFF).to(torch.uint8)[..., None],
                            (crc >> 8).to(torch.uint8)[..., None]], dim=-1)
    if cfg.whiten:
        # full-width (rdd=4) keystream, as the JAX twin: the reference's
        # codeword-width mask would leave the top payload bits of every
        # byte unwhitened for CR 4/5..4/7
        framed = coding.whiten_sx1272_lfsr(framed, 0, 4)
    nibbles = coding.bytes_to_nibbles(framed)
    ncw = nibbles.shape[-1]
    pad = -(-ncw // cfg.ppm) * cfg.ppm - ncw
    if pad:
        nibbles = torch.cat([nibbles, nibbles.new_zeros(*nibbles.shape[:-1], pad)],
                            dim=-1)
    codewords = _fec_encode(nibbles, cfg.cr)
    words = coding.diagonal_interleave(codewords, cfg.ppm, cfg.rdd)
    bins = coding.gray_to_binary(words)
    if cfg.ldro:
        bins = (bins << 2) & 0xFFFF
    return bins


def _check_crc(framed: torch.Tensor, payload: torch.Tensor, cfg: CodedConfig):
    """crc_ok [...]: the trailing CRC bytes against the payload's CRC16;
    all True without CRC."""
    if not cfg.crc:
        return torch.ones(payload.shape[:-1], dtype=torch.bool, device=payload.device)
    provided = framed[..., -2].to(torch.int32) | (framed[..., -1].to(torch.int32) << 8)
    return provided == coding.crc16_sx1272(payload)


def _ldro_demap(symbols: torch.Tensor, sf: int) -> torch.Tensor:
    """LDRO bins -> words: ``((s + 2) >> 2) % (N/4)`` in the JAX twin's
    uint16 arithmetic — round(bin/4), not truncation, so a -1 bin drift
    still demaps to the right word."""
    s = symbols.to(torch.int32) & 0xFFFF
    return (((s + 2) & 0xFFFF) >> 2) % (1 << (sf - 2))


def decode_payload(symbols: torch.Tensor, nbytes: int, cfg: CodedConfig):
    """[..., S] chirp bins -> (payload [..., nbytes] uint8, crc_ok [...]
    bool, fec_errors [...] int64).

    ``crc_ok`` is all-True when CRC is disabled; ``fec_errors`` counts
    codewords with detected parity errors (corrected where the code can).
    """
    symbols = symbols.to(torch.int32) & 0xFFFF
    if cfg.ldro:
        symbols = _ldro_demap(symbols, cfg.sf)
    words = coding.binary_to_gray(symbols)
    codewords = coding.diagonal_deinterleave(words, cfg.ppm, cfg.rdd)
    nibbles, err = _fec_decode(codewords, cfg.cr)
    total = nbytes + (2 if cfg.crc else 0)
    framed = coding.nibbles_to_bytes(nibbles[..., : total * 2])
    if cfg.whiten:
        framed = coding.whiten_sx1272_lfsr(framed, 0, 4)
    payload = framed[..., :nbytes]
    return payload, _check_crc(framed, payload, cfg), torch.sum(err, dim=-1)


# ---------------------------------------------------------------------------
# Explicit header (reference: LoRaCodes.hpp:16-18, 43-67 — HEADER_RDD=4)
# ---------------------------------------------------------------------------

HEADER_RDD = 4       # headers always use CR 4/8 (LoRaCodes.hpp:16-18)


def encode_header(nbytes: int, cfg: CodedConfig, device=None) -> torch.Tensor:
    """Explicit header, standard LoRa 5-nibble layout in the first
    interleaver block at PPM = sf-2, CR 4/8:
    ``[len_hi, len_lo, flags, chk_hi(1b), chk_lo]`` with
    ``flags = cr<<1 | crc_en`` and the reference's 5-bit header checksum
    over ``h = [len, flags]`` (LoRaCodes.hpp:43-67).
    LDRO is channel configuration (derived from SF/BW), not signalled.
    Returns [8] int32 header symbols (one PPM=sf-2 block at CR 4/8) on
    ``device`` (default: the first CUDA card)."""
    dev = device_of(None, device)
    flags = ((cfg.cr & 0x7) << 1) | int(cfg.crc)
    h = torch.tensor([nbytes & 0xFF, flags & 0x0F], dtype=torch.uint8)
    chk = int(coding.header_checksum(h))
    ppm = cfg.sf - 2
    nibbles = torch.zeros(ppm, dtype=torch.uint8)
    nibbles[:5] = torch.tensor([int(h[0]) >> 4, int(h[0]) & 0xF, int(h[1]) & 0xF,
                                (chk >> 4) & 0x1, chk & 0xF], dtype=torch.uint8)
    codewords = coding.hamming84_encode(nibbles.to(dev))
    words = coding.diagonal_interleave(codewords, ppm, HEADER_RDD)
    return (coding.gray_to_binary(words) << 2) & 0xFFFF


def decode_header(symbols: torch.Tensor, sf: int):
    """Inverse of :func:`encode_header`. Returns (nbytes, cr, crc_en, ok)
    as Python values. The 8 header bins are read to the host once and
    decoded there (the JAX twin also reads its nibbles to the host)."""
    ppm = sf - 2
    words = coding.binary_to_gray((symbols.cpu().to(torch.int32) & 0xFFFF) >> 2)
    codewords = coding.diagonal_deinterleave(words, ppm, HEADER_RDD)
    nib = coding.hamming84_decode(codewords)[0].reshape(-1).numpy()
    h = np.array([(nib[0] << 4) | nib[1], nib[2] & 0x0F], dtype=np.uint8)
    chk = ((nib[3] & 0x1) << 4) | (nib[4] & 0xF)
    ok = chk == int(coding.header_checksum(torch.from_numpy(h)))
    flags = int(h[1])
    return int(h[0]), (flags >> 1) & 0x7, bool(flags & 1), bool(ok)
