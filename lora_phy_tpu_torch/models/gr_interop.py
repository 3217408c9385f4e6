"""gr-lora_sdr interoperability — the PyTorch twin of
``lora_phy_tpu/models/gr_interop.py``: decodes frames produced by the
public GNU Radio gr-lora_sdr TX (the implementation the reference's
golden captures come from) and builds frames in its conventions.

  frame_sync (two-sided dechirp)             -> start, integer CFO
  header block: 8 symbols, PPM = sf-2, CR4/8 -> [len, flags, checksum]
  payload: bins -> (bin - 1) -> Gray-encode -> diagonal deinterleave
           (PPM = sf, RDD = cr) -> FEC check -> nibbles (low-high order)
           -> gr whitening LFSR (x^8+x^6+x^5+x^4+1, seed 0xFF)

The sync and demod run on the stream's device
(:func:`.stream.frame_sync` / :func:`.stream.frame_demodulate`); the
coding runs on the device of the bins it is given, and the host reads
the header nibbles and then the payload nibbles (two copies per frame).
The whitening keystream and the CRC are host NumPy / Python, copies of
the JAX twin's.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import LoraParams, device_of
from ..ops import coding
from . import soft as softmod
from . import stream
from .coded import _fec_decode, _fec_encode


@functools.lru_cache(maxsize=4)
def _gr_whitening_seq(n: int = 255) -> np.ndarray:
    """gr-lora_sdr whitening keystream: Fibonacci LFSR, polynomial
    x^8 + x^6 + x^5 + x^4 + 1 (taps 7,5,4,3 on the state byte), seed 0xFF,
    one byte consumed per payload byte."""
    s = 0xFF
    out = np.empty(n, np.uint8)
    for i in range(n):
        out[i] = s
        fb = ((s >> 7) ^ (s >> 5) ^ (s >> 4) ^ (s >> 3)) & 1
        s = ((s << 1) | fb) & 0xFF
    return out


def whiten_gr_lora(data):
    """XOR with the gr-lora_sdr keystream (involutive); host bytes."""
    data = np.asarray(data, np.uint8)
    return data ^ _gr_whitening_seq(max(255, data.shape[-1]))[: data.shape[-1]]


def crc16_gr_lora(payload: bytes) -> int:
    """gr-lora_sdr payload CRC: CRC16-CCITT (poly 0x1021, init 0) over
    ``payload[:-2]``, then XOR with the last two payload bytes
    (``^ payload[-1] ^ (payload[-2] << 8)``)."""
    crc = 0
    for b in payload[:-2]:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    if len(payload) >= 2:
        crc ^= payload[-1] | (payload[-2] << 8)
    return crc


@dataclasses.dataclass
class GrFrame:
    payload: bytes
    length: int
    cr: int                # 1..4 -> 4/5..4/8
    has_crc: bool
    crc_bytes: bytes       # raw trailer
    crc_ok: bool           # trailer == crc16_gr_lora(payload)
    header_ok: bool
    fec_errors: int
    start: int
    cfo_bins: int


# --- gr bin <-> interleaver-word maps (capture-validated conventions) ----
# reduced-rate blocks (the first block, and every block under LDRO): the
# two LSBs carry no data, no bin offset; full-rate blocks carry the gr
# demodulator's -1 bin offset. Integer tensors in, int32 words out.

def _rx_words_reduced(bins: torch.Tensor, n: int) -> torch.Tensor:
    # gr-lora_sdr demaps reduced-rate blocks with round(bin/4), not
    # truncation: a -1 bin drift (4w-1) still demaps to w
    w = (((bins % n) + 2) >> 2) % (n >> 2)
    return coding.binary_to_gray(w)


def _tx_bins_reduced(words: torch.Tensor, n: int) -> torch.Tensor:
    return (coding.gray_to_binary(words) << 2) % n


def _rx_words_full(bins: torch.Tensor, n: int) -> torch.Tensor:
    return coding.binary_to_gray((bins - 1) % n)


def _tx_bins_full(words: torch.Tensor, n: int) -> torch.Tensor:
    return (coding.gray_to_binary(words) + 1) % n


def payload_block_plan(sf: int, cr: int, length: int, crc: bool,
                       ldro: bool, implicit: bool):
    """gr-lora_sdr frame geometry: the first block is always reduced rate
    (PPM = sf-2, CR 4/8, 8 symbols) and carries either the 5 header
    nibbles plus ``sf-7`` payload nibbles (explicit header) or ``sf-2``
    payload nibbles (implicit); subsequent blocks run at PPM = sf (sf-2
    under LDRO) and 4+cr symbols. Returns
    ``(nibbles_in_first, ppm_rest, n_rest_blocks, total_payload_nibbles)``."""
    total_nibbles = 2 * (length + (2 if crc else 0))
    in_first = (sf - 2) if implicit else (sf - 2 - 5)
    in_first = max(0, min(in_first, total_nibbles))
    ppm_rest = (sf - 2) if ldro else sf
    rest = total_nibbles - in_first
    n_rest_blocks = -(-rest // ppm_rest) if rest else 0
    return in_first, ppm_rest, n_rest_blocks, total_nibbles


def decode_frame(samples, params: LoraParams, preamble_len: int = 8,
                 ldro: bool = False, implicit: bool = False,
                 length: int | None = None, cr: int | None = None,
                 crc: bool | None = None, soft: bool = False,
                 tx_phase_step: float | None = 0.0, device=None):
    """Detect and decode one gr-lora_sdr frame from a continuous stream
    (a complex64 tensor, or an array with ``device=``; default the first
    CUDA card).

    ``ldro``/``implicit`` select the capture-naming cells. Implicit-header
    mode has no in-band header, so ``length``/``cr``/``crc`` must be
    supplied. ``soft=True`` decodes header and payload from the symbol
    spectra by ML codeword correlation (:mod:`.soft`, with gr's bin
    conventions). ``tx_phase_step``: 0.0 for real gr-lora_sdr frames (no
    per-symbol phase step), ``None`` for frames from :func:`encode_frame`
    (this framework's lattice convention). Returns ``GrFrame`` or ``None``.
    """
    if implicit and (length is None or cr is None or crc is None):
        raise ValueError("implicit header needs length, cr and crc")
    samples = torch.as_tensor(samples, device=device_of(samples, device)).to(torch.complex64)
    res = stream.frame_sync(samples, params, preamble_len)
    if not res.found:
        return None
    avail = (samples.shape[-1] - res.payload_start) // params.step
    if avail < 8:
        return None
    dm = stream.frame_demodulate(samples, params, int(avail), preamble_len,
                                 tx_phase_step=tx_phase_step,
                                 return_spectra=soft,
                                 sync_result=res)
    out = dm[0]
    if out is None:
        return None
    return decode_bins(out.symbols, params.sf,
                       ldro=ldro, implicit=implicit, length=length, cr=cr,
                       crc=crc, soft=soft, mag2=dm[2] if soft else None,
                       start=res.start, cfo_bins=res.cfo_bins)


def decode_bins(bins, sf: int, ldro: bool = False, implicit: bool = False,
                length: int | None = None, cr: int | None = None,
                crc: bool | None = None, soft: bool = False, mag2=None,
                start: int = 0, cfo_bins: int = 0):
    """Decode one gr-lora_sdr frame from already-demodulated symbol bins
    (header first): the coding half of :func:`decode_frame`, shared by any
    demodulator that yields raw bins (the serial receiver, or the block
    and wideband receivers' ``BlockFrames.symbols`` rows with
    ``tx_phase_step=0.0``). ``bins`` is a tensor (the coding runs on its
    device) or an integer array (on the CPU); ``soft=True`` needs the
    matching ``mag2`` spectra. Returns ``GrFrame`` or ``None`` when the
    bins run out before the header-declared payload ends."""
    n = 1 << sf
    if implicit and (length is None or cr is None or crc is None):
        raise ValueError("implicit header needs length, cr and crc")
    if soft and mag2 is None:
        raise ValueError("soft=True requires the matching mag2 spectra")
    dev = bins.device if isinstance(bins, torch.Tensor) else torch.device("cpu")
    bins = torch.as_tensor(bins, device=dev).to(torch.int64)
    if mag2 is not None:
        mag2 = torch.as_tensor(mag2, device=dev)
    # "None when the bins run out" also covers the 8-symbol first block
    if bins.shape[0] < 8 or (soft and mag2.shape[0] < 8):
        return None

    # --- first block: 8 symbols, reduced rate (PPM = sf-2), CR 4/8 -------
    if soft:
        llr0 = softmod.bin_llrs(mag2[:8], sf - 2, shift=2)
        nib0, _ = softmod.ml_decode(softmod.deinterleave_llrs(llr0, sf - 2, 4), 4)
        nib0 = nib0.cpu().numpy().astype(np.int64)
        fec_errors = 0
    else:
        cw0 = coding.diagonal_deinterleave(_rx_words_reduced(bins[:8], n), sf - 2, 4)
        nib0, err0 = _fec_decode(cw0, 4)
        host = torch.cat([nib0.to(torch.int64), err0.to(torch.int64).sum()[None]]).cpu().numpy()
        nib0, fec_errors = host[:-1], int(host[-1])

    header_ok = True
    if implicit:
        has_crc = bool(crc)
        first_payload_nib = nib0
    else:
        length = int((nib0[0] << 4) | nib0[1])
        flags = int(nib0[2])
        cr = (flags >> 1) & 0x7
        has_crc = bool(flags & 1)
        chk = ((int(nib0[3]) & 0x1) << 4) | int(nib0[4])
        h = torch.tensor([length & 0xFF, flags & 0x0F], dtype=torch.uint8)
        header_ok = chk == int(coding.header_checksum(h))
        first_payload_nib = nib0[5:]
        if cr < 1 or cr > 4 or length == 0:
            return GrFrame(b"", length, cr, has_crc, b"", False, header_ok, 0,
                           start, cfo_bins)

    in_first, ppm_rest, n_rest, total_nibbles = payload_block_plan(
        sf, cr, length, has_crc, ldro, implicit
    )

    # --- remaining blocks: PPM = sf (sf-2 under LDRO), RDD = cr ----------
    nsym = n_rest * (4 + cr)
    pay_bins = bins[8: 8 + nsym]
    if pay_bins.shape[-1] < nsym:
        return None
    if soft and mag2.shape[0] < 8 + nsym:
        return None                     # truncated spectra, not short LLRs
    if nsym and soft:
        llrp = softmod.bin_llrs(mag2[8: 8 + nsym], ppm_rest,
                                shift=2 if ldro else 0,
                                offset=0 if ldro else 1)
        nibp, _ = softmod.ml_decode(
            softmod.deinterleave_llrs(llrp, ppm_rest, cr), cr)
        nibp = nibp.cpu().numpy().astype(np.int64)
    elif nsym:
        w = (_rx_words_reduced(pay_bins, n) if ldro
             else _rx_words_full(pay_bins, n))
        nibp, errp = _fec_decode(coding.diagonal_deinterleave(w, ppm_rest, cr), cr)
        host = torch.cat([nibp.to(torch.int64), errp.to(torch.int64).sum()[None]]).cpu().numpy()
        nibp = host[:-1]
        fec_errors += int(host[-1])
    else:
        nibp = np.zeros(0, np.int64)

    nib = np.concatenate([first_payload_nib[:in_first], nibp])[:total_nibbles]
    # gr nibble order is low-then-high within each byte
    swapped = nib.reshape(-1, 2)[:, ::-1].reshape(-1).astype(np.uint8)
    data = coding.nibbles_to_bytes(torch.from_numpy(swapped.copy())).numpy()
    total_bytes = length + (2 if has_crc else 0)
    payload = whiten_gr_lora(data[:length]).tobytes()
    crc_bytes = data[length:total_bytes].tobytes() if has_crc else b""
    crc_ok = bool(
        has_crc and len(crc_bytes) == 2
        and (crc_bytes[0] | (crc_bytes[1] << 8)) == crc16_gr_lora(payload)
    )
    return GrFrame(payload, length, cr, has_crc, crc_bytes, crc_ok,
                   header_ok, fec_errors, start, cfo_bins)


def encode_frame(payload: bytes, params: LoraParams, cr: int = 1,
                 crc: bool = True, preamble_len: int = 8,
                 ldro: bool = False, implicit: bool = False, device=None):
    """Build a gr-lora_sdr-convention frame for ``payload``: the exact
    inverse of :func:`decode_frame` across all four ``ldro`` x
    ``implheader`` cells (reduced-rate first block carrying header+payload
    or pure payload, gr whitening LFSR, low-high nibble order, per-block
    bin maps), wrapped in the standard preamble/sync/2.25-downchirp frame
    on this framework's phase-continuous lattice (see the JAX twin for why
    not gr's per-symbol phase). The symbols are built on the host (CPU
    tensors, a few dozen values); the frame is a complex64 tensor on
    ``device`` (default: the first CUDA card). Decode it with
    ``decode_frame(..., tx_phase_step=None)``."""
    sf = params.sf
    n = params.n
    length = len(payload)

    # --- payload nibble stream (whitened payload + raw CRC trailer) ------
    data = np.frombuffer(payload, dtype=np.uint8)
    if crc:
        c = crc16_gr_lora(payload)
        trailer = np.array([c & 0xFF, c >> 8], dtype=np.uint8)
    else:
        trailer = np.zeros(0, np.uint8)
    framed = np.concatenate([whiten_gr_lora(data), trailer])
    nibbles = coding.bytes_to_nibbles(torch.from_numpy(framed)).numpy()
    nibbles = nibbles.reshape(-1, 2)[:, ::-1].reshape(-1)   # low then high

    in_first, ppm_rest, n_rest, total_nibbles = payload_block_plan(
        sf, cr, length, crc, ldro, implicit
    )

    # --- first block (reduced rate, CR 4/8) ------------------------------
    nib0 = np.zeros(sf - 2, dtype=np.uint8)
    if implicit:
        nib0[:in_first] = nibbles[:in_first]
    else:
        flags = ((cr & 0x7) << 1) | int(crc)
        h = torch.tensor([length & 0xFF, flags & 0x0F], dtype=torch.uint8)
        chk = int(coding.header_checksum(h))
        nib0[:5] = [length >> 4, length & 0xF, flags & 0xF, (chk >> 4) & 0x1,
                    chk & 0xF]
        nib0[5:5 + in_first] = nibbles[:in_first]
    cw0 = coding.hamming84_encode(torch.from_numpy(nib0))
    bins0 = _tx_bins_reduced(coding.diagonal_interleave(cw0, sf - 2, 4), n)

    # --- remaining blocks ------------------------------------------------
    rest = nibbles[in_first:]
    pad = n_rest * ppm_rest - rest.size
    if pad:
        rest = np.concatenate([rest, np.zeros(pad, np.uint8)])
    if rest.size:
        cw = _fec_encode(torch.from_numpy(rest.copy()), cr)
        w = coding.diagonal_interleave(cw, ppm_rest, cr)
        pbins = _tx_bins_reduced(w, n) if ldro else _tx_bins_full(w, n)
    else:
        pbins = torch.zeros(0, dtype=torch.int32)

    symbols = torch.cat([bins0.to(torch.int32), pbins.to(torch.int32)])
    return stream.frame_modulate(symbols.to(device_of(None, device)), params,
                                 preamble_len=preamble_len)
