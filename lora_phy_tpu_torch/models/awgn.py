"""AWGN channel simulation — the PyTorch twin of
``lora_phy_tpu/models/awgn.py``, the executable spec of the reference's
``tests/awgn_sweep.py`` (SURVEY.md §3.5): all packets of an SNR point are
simulated in one tensor pass (packets x symbols x N).

Model contract (reference: tests/awgn_sweep.py:233-273):
  chirp  = exp(j*cumsum(-pi + 2*pi*n/N)), down = conj(up)
  tx     = up * exp(j*2*pi*sym*n/N) + AWGN(sigma = 10**(-snr/20))
  rx_sym = argmax |FFT(rx * down)|
FEC: CR 4/5 parity54 (detect-only) .. 4/8 Hamming84 (single-error
correction), LSB-first bit packing into sf-bit symbols
(awgn_sweep.py:159-215).

Random draws: the JAX twin draws payloads and noise with threefry inside
its jit. Here the point functions draw them from a ``torch.Generator``
(payload bytes, then the real noise plane, then the imaginary one), or
take them injected (``payload``, ``noise``), so a caller can feed any
draws, JAX's own included; ``simulate`` / ``simulate_planar`` seed a
generator on the device from ``seed``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import device_of, device_table
from ..ops import coding
from ..ops.chirp import model_chirps, model_chirps_planar
from ..ops.detect import detect
from ..ops.planar import argmax_bins_planar

_WIDTH = {"4/5": 5, "4/6": 6, "4/7": 7, "4/8": 8}


class SweepPoint(NamedTuple):
    snr_db: float
    ber: float
    per: float


def encode_payload_bits(payload: torch.Tensor, cr: str) -> torch.Tensor:
    """[..., B] bytes -> [..., bits] LSB-first codeword bit stream, int32
    (reference: awgn_sweep.py:159-174)."""
    nibbles = coding.bytes_to_nibbles(payload)
    if cr == "4/5":
        cw = coding.parity54_encode(nibbles)
    elif cr == "4/6":
        cw = coding.parity64_encode(nibbles)
    elif cr == "4/7":
        cw = coding.hamming74_encode(nibbles)
    elif cr == "4/8":
        cw = coding.hamming84_encode(nibbles)
    else:
        raise ValueError(f"Unsupported coding rate: {cr}")
    bits = coding.unpack_bits(cw.to(torch.int32), _WIDTH[cr])
    return bits.reshape(*bits.shape[:-2], -1)


def decode_payload_bits(bits: torch.Tensor, cr: str, num_bytes: int) -> torch.Tensor:
    """Inverse of :func:`encode_payload_bits` (awgn_sweep.py:177-202)."""
    width = _WIDTH[cr]
    cw_bits = bits[..., : num_bytes * 2 * width].reshape(
        *bits.shape[:-1], num_bytes * 2, width)
    cw = coding.pack_bits(cw_bits, dtype=torch.uint8)
    if cr in ("4/5", "4/6"):
        nibbles = cw & 0xF                       # detect-only codes
    elif cr == "4/7":
        nibbles, _ = coding.hamming74_decode(cw)
    else:
        nibbles, _, _ = coding.hamming84_decode(cw)
    return coding.nibbles_to_bytes(nibbles)


def bits_to_symbols(bits: torch.Tensor, sf: int) -> torch.Tensor:
    """Pack LSB-first bits into sf-bit symbols, zero-padded tail
    (awgn_sweep.py:205-215). int32, masked to 16 bits where the JAX twin
    packs into uint16 (a no-op for sf <= 16)."""
    nbits = bits.shape[-1]
    nsym = -(-nbits // sf)
    pad = nsym * sf - nbits
    if pad:
        bits = torch.cat([bits, bits.new_zeros(*bits.shape[:-1], pad)], dim=-1)
    return coding.pack_bits(bits.reshape(*bits.shape[:-1], nsym, sf)) & 0xFFFF


def symbols_to_bits(symbols: torch.Tensor, sf: int, bit_len: int) -> torch.Tensor:
    """Unpack symbols to LSB-first bits, truncated to ``bit_len``
    (awgn_sweep.py:218-225)."""
    bits = coding.unpack_bits(symbols.to(torch.int32), sf)
    return bits.reshape(*bits.shape[:-2], -1)[..., :bit_len]


def _payload(generator, payload, packets: int, payload_len: int, dev) -> torch.Tensor:
    if payload is not None:
        return torch.as_tensor(payload, device=dev).to(torch.uint8)
    return torch.randint(0, 256, (packets, payload_len), generator=generator,
                         dtype=torch.int32, device=dev).to(torch.uint8)


def _noise(generator, noise, shape, dev):
    """Unit-variance real and imaginary noise planes: injected or drawn."""
    if noise is not None:
        return tuple(torch.as_tensor(a, device=dev).to(torch.float32) for a in noise)
    return tuple(torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
                 for _ in range(2))


def _errors(payload: torch.Tensor, rx_payload: torch.Tensor):
    diff = torch.bitwise_xor(payload, rx_payload)
    bit_errors = coding.unpack_bits(diff.to(torch.int32), 8).sum()
    packet_errors = (diff != 0).any(dim=-1).sum()
    return bit_errors, packet_errors


def _simulate_point(snr_db: float, sf: int, cr: str, packets: int, payload_len: int,
                    generator: torch.Generator | None = None, payload=None, noise=None,
                    device=None):
    """One SNR point on the complex path, all packets batched. Returns
    (bit_errors, packet_errors) as 0-d int64 tensors on the device.

    ``payload`` ([packets, payload_len] bytes) and ``noise`` (the
    unit-variance (re, im) planes [packets, symbols, N] that the JAX
    twin's ``apply_awgn`` scales by ``sigma/sqrt(2)``) override the draws
    from ``generator``. The device is the generator's, else the injected
    payload tensor's, else ``device`` (default: the first CUDA card)."""
    dev = device_of(payload, device) if generator is None else generator.device
    n = 1 << sf
    up, down = model_chirps(sf, device=dev)
    payload = _payload(generator, payload, packets, payload_len, dev)
    tx_bits = encode_payload_bits(payload, cr)
    symbols = bits_to_symbols(tx_bits, sf)                      # [P, S]
    nbits = tx_bits.shape[-1]

    idx = torch.arange(n, dtype=torch.float32, device=dev)
    ph = (2.0 * math.pi / n) * symbols.to(torch.float32)[..., None] * idx
    tx = up * torch.complex(torch.cos(ph), torch.sin(ph))      # [P, S, N]
    nr, ni = _noise(generator, noise, tx.shape, dev)
    sigma = 10.0 ** (-torch.tensor(snr_db, dtype=torch.float32, device=dev) / 20.0)
    scale = sigma / np.float32(math.sqrt(2.0))
    rx = tx + torch.complex(nr * scale, ni * scale)

    det = detect(rx * down)
    rx_bits = symbols_to_bits(det.index, sf, nbits)
    return _errors(payload, decode_payload_bits(rx_bits, cr, payload_len))


@functools.lru_cache(maxsize=8)
def _tone_tables(n: int):
    """[n, n] cos/sin float32 tables of ``exp(j*2*pi*s*i/n)`` — one row
    per symbol value; float64-built (a copy of the JAX twin's)."""
    k = np.arange(n, dtype=np.float64)
    ang = (2.0 * np.pi / n) * np.outer(k, k)
    return (np.cos(ang).astype(np.float32),
            np.sin(ang).astype(np.float32))


def _simulate_point_planar(snr_db: float, sf: int, cr: str, packets: int,
                           payload_len: int, generator: torch.Generator | None = None,
                           payload=None, noise=None, device=None):
    """Planar twin of :func:`_simulate_point`: the same model in split
    re/im float32 arithmetic, the tone synthesis a row gather from the
    [n, n] :func:`_tone_tables` and the detection decision-only
    (:func:`..ops.planar.argmax_bins_planar`), as the JAX twin."""
    dev = device_of(payload, device) if generator is None else generator.device
    n = 1 << sf
    up_re, up_im = device_table(model_chirps_planar, sf, device=dev)
    payload = _payload(generator, payload, packets, payload_len, dev)
    tx_bits = encode_payload_bits(payload, cr)
    symbols = bits_to_symbols(tx_bits, sf)                      # [P, S]
    nbits = tx_bits.shape[-1]

    tc, ts = device_table(_tone_tables, n, device=dev)
    sym_i = symbols.to(torch.int64)
    c, s = tc[sym_i], ts[sym_i]                                 # [P, S, N]
    tx_re = up_re * c - up_im * s
    tx_im = up_re * s + up_im * c
    del c, s

    nr, ni = _noise(generator, noise, tx_re.shape, dev)
    sigma = 10.0 ** (-torch.tensor(snr_db, dtype=torch.float32, device=dev) / 20.0)
    k2 = sigma / np.float32(math.sqrt(2.0))
    rx_re = tx_re + k2 * nr
    rx_im = tx_im + k2 * ni
    del tx_re, tx_im, nr, ni

    # dechirp by conj(up): (a+jb)(ur-jui) planar
    dr = rx_re * up_re + rx_im * up_im
    di = rx_im * up_re - rx_re * up_im
    del rx_re, rx_im
    rx_bits = symbols_to_bits(argmax_bins_planar(dr, di, n), sf, nbits)
    return _errors(payload, decode_payload_bits(rx_bits, cr, payload_len))


def _point(fn, sf, cr, snr_db, packets, payload_len, seed, device) -> SweepPoint:
    dev = device_of(None, device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    bit_errors, packet_errors = (int(v) for v in torch.stack(
        fn(float(snr_db), sf, cr, packets, payload_len, gen)).cpu())
    total_bits = packets * payload_len * 8
    return SweepPoint(
        float(snr_db),
        float(bit_errors) / total_bits if total_bits else 0.0,
        float(packet_errors) / packets if packets else 0.0,
    )


def simulate(sf: int, cr: str, snr_db: float, packets: int, payload_len: int,
             seed: int = 0, device=None) -> SweepPoint:
    """BER/PER at one SNR point (reference: awgn_sweep.py:245-285), on
    ``device`` (default: the first CUDA card) with draws seeded by
    ``seed``."""
    return _point(_simulate_point, sf, cr, snr_db, packets, payload_len, seed, device)


def simulate_planar(sf: int, cr: str, snr_db: float, packets: int,
                    payload_len: int, seed: int = 0, device=None) -> SweepPoint:
    """BER/PER at one SNR point via the planar path."""
    return _point(_simulate_point_planar, sf, cr, snr_db, packets, payload_len, seed,
                  device)


def sweep(profiles, snr_start=0.0, snr_stop=12.0, snr_step=0.5,
          packets=100, payload_len=16, seed=0, device=None):
    """Full sweep over profiles; yields CSV-schema rows
    ``{sf, bw, cr, snr_db, ber, per}`` (reference: awgn_sweep.py:304-346)."""
    rows = []
    for p in profiles:
        snrs = np.arange(snr_start, snr_stop + 1e-9, snr_step)
        for i, snr in enumerate(snrs):
            pt = simulate(p.sf, p.cr, float(snr), packets, payload_len,
                          seed=seed + i, device=device)
            rows.append({
                "sf": p.sf, "bw": p.bw, "cr": p.cr,
                "snr_db": float(snr), "ber": pt.ber, "per": pt.per,
            })
    return rows


def write_csv(rows, path):
    import csv

    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["sf", "bw", "cr", "snr_db", "ber", "per"])
        w.writeheader()
        for r in rows:
            w.writerow(r)
