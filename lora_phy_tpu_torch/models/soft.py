"""Soft-decision coded-chain decoding on tensors — the PyTorch twin of
``lora_phy_tpu/models/soft.py``.

Per-symbol max-log bit LLRs come straight out of the demodulator's |DFT|²
spectra (:func:`..ops.planar.demodulate_spectrum_planar`) as masked
max-reductions, ride the hard deinterleaver's gather map
(``coding._deinterleave_map``) on float lanes, and FEC decoding is a
maximum-likelihood correlation against the 16-entry codeword book — one
``[.., nbits] @ [nbits, 16]`` matmul. :func:`hamming84_ml_decode` is the
constrained argmax for the simple Hamming 8/4 chain, one
``[.., N] @ [N, 16]`` one-hot matmul (an exact pick).

The bit masks and the codebook are built in NumPy from this package's
own coding tables and uploaded once per device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import device_table
from ..ops import coding
from .coded import CodedConfig, _check_crc

_NEG = float(np.float32(-3.4e38))
_FEC_ENC = {1: coding._P54_ENC, 2: coding._P64_ENC, 3: coding._H74_ENC,
            4: coding._H84_ENC}


@functools.lru_cache(maxsize=64)
def _bit_masks(n: int, ppm: int, shift: int, offset: int = 0) -> np.ndarray:
    """[ppm, N] bool: bit ``j`` of the data word carried by bin ``b``.

    Word = binary_to_gray(round(((b - offset) mod N) / 2^shift)) — the RX
    mapping of :func:`.coded.decode_payload` (rounding, as the hard
    demaps); ``shift=2`` for LDRO blocks where the two LSB bins carry no
    data, ``offset=1`` for gr-lora_sdr's full-rate -1 bin convention."""
    b = ((np.arange(n, dtype=np.int32) - offset) % n).astype(np.uint16)
    if shift:
        b = ((b + (1 << (shift - 1))) >> shift) % (n >> shift)
    w = (b ^ (b >> 1)).astype(np.uint32)                 # binary_to_gray
    j = np.arange(ppm, dtype=np.uint32)[:, None]
    return ((w[None, :] >> j) & 1).astype(bool)


@functools.lru_cache(maxsize=16)
def _codebook(cr: int) -> np.ndarray:
    """[nbits, 16] float32 antipodal (±1) codeword book for ML scoring,
    LSB-first bit order (matching coding.unpack_bits)."""
    cw = _FEC_ENC[cr][np.arange(16)].astype(np.uint32)
    nbits = 4 + cr
    j = np.arange(nbits, dtype=np.uint32)[:, None]
    bits = ((cw[None, :] >> j) & 1).astype(np.float32)
    return 2.0 * bits - 1.0                               # [nbits, 16]


def bin_llrs(mag2: torch.Tensor, ppm: int, shift: int, offset: int = 0) -> torch.Tensor:
    """[..., S, N] symbol spectra -> [..., S, ppm] max-log bit LLRs for
    an explicit bin->word mapping (see :func:`_bit_masks`).

    ``LLR_j = max_{bin: bit_j=1} |X| - max_{bin: bit_j=0} |X|``. Inputs
    are clamped at zero before the sqrt (a noncoherent combining score
    can round slightly negative). Makes an [..., S, ppm, N] temporary per
    max, as the JAX twin."""
    n = mag2.shape[-1]
    masks = device_table(_bit_masks, n, ppm, shift, offset, device=mag2.device)
    m = torch.sqrt(torch.clamp(mag2, min=0.0))[..., None, :]    # [..., S, 1, N]
    one = torch.where(masks, m, _NEG).amax(dim=-1)               # [..., S, ppm]
    zero = torch.where(~masks, m, _NEG).amax(dim=-1)
    return (one - zero).to(torch.float32)


def symbol_llrs(mag2: torch.Tensor, cfg: CodedConfig) -> torch.Tensor:
    """[..., S, N] symbol spectra -> [..., S, ppm] max-log bit LLRs for
    the coded chain's bin mapping (:mod:`.coded`)."""
    return bin_llrs(mag2, cfg.ppm, 2 if cfg.ldro else 0)


def ml_decode(cw_llrs: torch.Tensor, cr: int):
    """[..., ncw, nbits] codeword-bit LLRs -> ([..., ncw] uint8 nibbles,
    [..., ncw] correlation margins: best minus second-best score)."""
    scores = cw_llrs @ device_table(_codebook, cr, device=cw_llrs.device)
    nibbles = torch.argmax(scores, dim=-1).to(torch.uint8)   # first maximum
    top2 = torch.topk(scores, 2, dim=-1).values
    return nibbles, top2[..., 0] - top2[..., 1]


def deinterleave_llrs(llrs: torch.Tensor, ppm: int, rdd: int) -> torch.Tensor:
    """[..., S, ppm] symbol-bit LLRs -> [..., S//(4+rdd)*ppm, 4+rdd]
    codeword-bit LLRs — the hard deinterleaver's gather map applied to
    float lanes (reference: LoRaCodes.hpp:396-412)."""
    nbits = 4 + rdd
    nblk = llrs.shape[-2] // nbits
    lead = llrs.shape[:-2]
    flat = llrs[..., : nblk * nbits, :].reshape(*lead, nblk, nbits * ppm)
    sel = flat[..., device_table(coding._map_i64, coding._deinterleave_map, ppm, rdd,
                                 device=flat.device)]
    return sel.reshape(*lead, nblk * ppm, nbits)


@functools.lru_cache(maxsize=16)
def _hamming84_bin_onehot(n: int, scale: int = 1) -> np.ndarray:
    """[n, 16] float32 one-hot columns at each valid Hamming(8,4)
    codeword's demodulated bin (``cw * scale mod n`` — bw_scale aliases
    bins at BW250/500). Distinctness is guaranteed by the code's minimum
    distance (4); checked anyway."""
    bins = (coding._H84_ENC.astype(np.int64) * scale) % n
    if len(set(int(b) for b in bins)) != 16:
        raise ValueError(f"codeword bins collide at n={n}, scale={scale}")
    oh = np.zeros((n, 16), np.float32)
    oh[bins, np.arange(16)] = 1.0
    return oh


def hamming84_ml_decode(mag2: torch.Tensor, scale: int = 1) -> torch.Tensor:
    """Maximum-likelihood soft detection for the simple Hamming(8,4)
    chain: ``[..., 2B, N]`` payload-symbol spectra -> ``[..., B]`` bytes.

    The argmax is constrained to the 16 bins that carry valid codewords —
    one ``[.., N] @ [N, 16]`` one-hot product (an exact pick: each score
    is one spectrum value) and a first-maximum argmax. Feed it
    ``receive_block_planar(..., with_spectra=True)`` spectra or
    ``demodulate_spectrum_planar`` mag2. ``scale``: ``int(params.scale)``
    for BW250/500 bin aliasing."""
    n = mag2.shape[-1]
    s = mag2.shape[-2] - (mag2.shape[-2] % 2)
    onehot = device_table(_hamming84_bin_onehot, n, scale, device=mag2.device)
    scores = mag2[..., :s, :].to(torch.float32) @ onehot
    return coding.nibbles_to_bytes(torch.argmax(scores, dim=-1).to(torch.uint8))


def decode_payload_soft(mag2: torch.Tensor, nbytes: int, cfg: CodedConfig):
    """[..., S, N] data-symbol spectra -> (payload [..., nbytes] uint8,
    crc_ok [...] bool, min_score [...] float32).

    Soft twin of :func:`.coded.decode_payload`: LLRs -> deinterleave -> ML
    codeword correlation -> nibbles -> bytes -> dewhiten -> CRC.
    ``min_score`` is the weakest codeword correlation margin (larger is
    more confident)."""
    llrs = symbol_llrs(mag2, cfg)
    cw_llrs = deinterleave_llrs(llrs, cfg.ppm, cfg.rdd)   # [..., ncw, nbits]
    nibbles, margin = ml_decode(cw_llrs, cfg.cr)
    total = nbytes + (2 if cfg.crc else 0)
    framed = coding.nibbles_to_bytes(nibbles[..., : total * 2])
    if cfg.whiten:
        framed = coding.whiten_sx1272_lfsr(framed, 0, 4)
    payload = framed[..., :nbytes]
    min_score = torch.amin(margin[..., : total * 2], dim=-1)
    return payload, _check_crc(framed, payload, cfg), min_score
