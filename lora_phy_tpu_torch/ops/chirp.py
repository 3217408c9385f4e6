"""Chirp synthesis on an exact integer phase lattice — the PyTorch twin of
``lora_phy_tpu/ops/chirp.py`` (see its module docstring for the lattice
derivation: every phase of the reference's sequential float32 chirp
recurrence is an integer multiple of ``fStep``, so the modulator is a
closed form reduced mod ``P`` in integer arithmetic).

The NumPy builders (``_lattice_period``, ``gen_chirp_np``,
``_mod_chirp_tables``, ``base_downchirp_planar``) are copies of the JAX
module's, so the tables are bit-equal; the device code is torch. The
complex ``modulate_symbols`` / ``base_downchirp`` are built from the
planar planes, as in the JAX twin.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import device_of, device_table


def _lattice_period(n: int, osr: int, bw_scale: float) -> tuple[float, int]:
    """(fStep, P) with fStep * P == 2*pi exactly in the reals."""
    f_step = (2.0 * math.pi * bw_scale) / (n * osr * osr)
    p = n * osr * osr / bw_scale
    p_int = int(round(p))
    if abs(p - p_int) > 1e-9:
        raise ValueError(f"bw_scale {bw_scale} does not divide the lattice")
    return f_step, p_int


def gen_chirp_np(
    n: int,
    osr: int,
    nn: int,
    f0: float,
    down: bool,
    ampl: float = 1.0,
    phase0: float = 0.0,
    bw_scale: float = 1.0,
):
    """Host-side (NumPy, float64) equivalent of the reference ``genChirp``
    (ChirpGenerator.hpp:23-50) for arbitrary ``f0``. Returns
    ``(samples[nn] complex64, phase_accum_out float)``."""
    f_min = -math.pi * bw_scale / osr
    f_step = (2.0 * math.pi * bw_scale) / (n * osr * osr)
    m = n * osr
    k = np.arange(nn, dtype=np.float64)
    u = f0 / f_step + k + 1.0                     # in fStep units
    v = u - (np.ceil(u / m) - 1.0) * m            # wrapped into (0, M]
    f = f_min + v * f_step
    csum = np.cumsum(f)
    phase = phase0 + (-csum if down else csum)
    samples = (ampl * np.exp(1j * phase)).astype(np.complex64)
    end = float(phase[-1])
    end -= math.floor(end / (2 * math.pi)) * (2 * math.pi)
    return samples, end


def gen_chirp(
    n: int,
    osr: int,
    nn: int,
    f0: float,
    down: bool,
    ampl: float = 1.0,
    phase0: float = 0.0,
    bw_scale: float = 1.0,
    device=None,
):
    """:func:`gen_chirp_np` with its samples as a complex64 tensor on
    ``device`` (default: the first CUDA card): ``(samples[nn],
    phase_accum_out float)``, the phase carry of ChirpGenerator.hpp:48."""
    samples, end = gen_chirp_np(n, osr, nn, f0, down, ampl, phase0, bw_scale)
    return torch.from_numpy(samples).to(device_of(None, device)), end


# int32 intermediates of the lattice reach ~M^2 and wrap for M >= 46341
_INT32_LATTICE_MAX_M = 46341


def _chirp_phase(symbols: torch.Tensor, n: int, osr: int, bw_scale_x8: int,
                 continuous: bool = False, phase_carry: bool = True) -> torch.Tensor:
    """Integer-lattice phase of phase-continuous upchirps: ``symbols``
    [..., S] -> float32 [..., S, N*osr] (reference continuity,
    LoRaMod.cpp:34-41, in closed form; see the JAX twin for the algebra).

    The lattice is int32 as in JAX. Where ``M = N*osr`` is large enough
    for the int32 intermediates to wrap, JAX relies on the wrap being the
    modular reduction (exact when ``P`` divides 2^32); here such a lattice
    is computed in int64 instead, which gives the same residues without
    relying on overflow. The guard that refuses a lattice whose period
    does not divide 2^32 is kept, so both packages accept the same
    configurations.
    """
    bw_scale = bw_scale_x8 / 8.0
    f_step, p = _lattice_period(n, osr, bw_scale)
    m = n * osr
    half_m = m // 2
    if m >= _INT32_LATTICE_MAX_M and (1 << 32) % p != 0:
        raise ValueError(
            f"N*osr = {m} overflows the int32 phase lattice and its period "
            f"P = {p} does not divide 2^32; use a power-of-two osr")
    ity = torch.int32 if m < _INT32_LATTICE_MAX_M else torch.int64
    dev = symbols.device

    ks = torch.arange(m, dtype=ity, device=dev)
    w = (symbols.to(ity) * osr)[..., None]                 # [..., S, 1]
    k1 = ks + 1                                            # [M]
    off = 1 if continuous else 0
    wraps = torch.clamp(k1 + w - m - off, min=0)           # [..., S, M]
    s_cum = k1 * (w + 1) + (ks * k1) // 2 - m * wraps      # <= M(M+1)
    t_lattice = s_cum - half_m * k1                        # phase / fStep

    s_idx = torch.arange(symbols.shape[-1], dtype=ity, device=dev)
    carry = (s_idx * half_m) % p if phase_carry else torch.zeros_like(s_idx)
    lattice = (carry[:, None] + t_lattice) % p             # [..., S, M] in [0, P)
    return lattice.to(torch.float32) * float(np.float32(f_step))


_TX_TABLE_BUDGET_BYTES = 16 * 1024 * 1024


@functools.lru_cache(maxsize=8)
def _mod_chirp_tables(n: int, osr: int, bw_scale_x8: int, continuous: bool,
                      phase_carry: bool = True):
    """``(carry_period, cos_table, sin_table)`` with tables
    ``[period*2N, M]`` float32 (row ``c*2N + w`` = slot-class c, symbol w),
    or ``None`` when a table would exceed the per-plane budget.

    Built in float64 NumPy from the same integer lattice as
    :func:`_chirp_phase`. 2N value rows, not N: the simple chain's
    Hamming 8/4 symbols are 8-bit and alias mod N at SF7 by design."""
    bw_scale = bw_scale_x8 / 8.0
    f_step, p = _lattice_period(n, osr, bw_scale)
    m = n * osr
    half_m = m // 2
    period = p // math.gcd(half_m, p) if phase_carry else 1
    n_rows = 2 * n
    if period * n_rows * m * 4 > _TX_TABLE_BUDGET_BYTES:
        return None
    ks = np.arange(m, dtype=np.int64)
    k1 = ks + 1
    w = (np.arange(n_rows, dtype=np.int64) * osr)[:, None]  # [2N, 1]
    off = 1 if continuous else 0
    wraps = np.maximum(0, k1[None, :] + w - m - off)
    s_cum = k1 * (w + 1) + (ks * k1) // 2 - m * wraps
    t_lat = s_cum - half_m * k1                            # [2N, M]
    carry = (np.arange(period, dtype=np.int64) * half_m) % p
    lat = (carry[:, None, None] + t_lat[None]) % p         # [period, 2N, M]
    ang = lat.astype(np.float64) * f_step
    return (period,
            np.cos(ang).astype(np.float32).reshape(period * n_rows, m),
            np.sin(ang).astype(np.float32).reshape(period * n_rows, m))


def _mod_chirps_planar(symbols: torch.Tensor, n: int, osr: int, bw_scale_x8: int,
                       ampl: float, continuous: bool = False,
                       phase_carry: bool = True):
    """Planar (re, im float32) phase-continuous upchirps [..., S, N*osr].

    The table gather when the :func:`_mod_chirp_tables` budget allows
    (one row gather per plane, no device trig), else the closed-form
    lattice trig path. Symbols are reduced mod 2N in both paths, as in
    the JAX twin."""
    ampl = float(np.float32(ampl))
    symbols = symbols.to(torch.int64) % (2 * n)
    tabs = device_table(_mod_chirp_tables, n, osr, bw_scale_x8, continuous,
                        phase_carry, device=symbols.device)
    if tabs is None:
        phase = _chirp_phase(symbols, n, osr, bw_scale_x8, continuous,
                             phase_carry)
        return ampl * torch.cos(phase), ampl * torch.sin(phase)
    period, tc, ts = tabs
    s_idx = torch.arange(symbols.shape[-1], device=symbols.device) % period
    idx = symbols + 2 * n * s_idx
    return ampl * tc[idx], ampl * ts[idx]


def _tx_symbol_plan(symbols: torch.Tensor, sf: int, sync_word: int) -> torch.Tensor:
    """Prepend the 2 sync-word upchirp symbols (LoRaMod.cpp:20-32), int32."""
    shift = (sf - 4) if sf > 4 else 0
    sw0 = ((sync_word >> 4) & 0xF) << shift
    sw1 = (sync_word & 0xF) << shift
    sync = torch.tensor([sw0, sw1], dtype=torch.int32, device=symbols.device)
    sync = sync.expand(*symbols.shape[:-1], 2)
    return torch.cat([sync, symbols.to(torch.int32)], dim=-1)


def modulate_symbols_planar(symbols: torch.Tensor, sf: int, osr: int,
                            bw_scale: float, ampl: float = 1.0,
                            sync_word: int = 0x12, continuous: bool = False,
                            phase_carry: bool = True):
    """The full ``lora_modulate`` TX chain (src/phy/LoRaMod.cpp:8-43) as
    (re, im) float32 planes: 2 sync upchirps then one per symbol,
    phase-continuous. [..., S] -> ((re, im) each [..., (S+2)*N*osr])."""
    allsyms = _tx_symbol_plan(symbols, sf, sync_word)
    ampl = float(np.clip(ampl, -1.0, 1.0))
    bw8 = int(round(bw_scale * 8))
    re, im = _mod_chirps_planar(allsyms, 1 << sf, osr, bw8, ampl, continuous,
                                phase_carry)
    return (re.reshape(*re.shape[:-2], -1), im.reshape(*im.shape[:-2], -1))


def modulate_symbols(symbols: torch.Tensor, sf: int, osr: int, bw_scale: float,
                     ampl: float = 1.0, sync_word: int = 0x12,
                     continuous: bool = False, phase_carry: bool = True) -> torch.Tensor:
    """The ``lora_modulate`` TX chain (src/phy/LoRaMod.cpp:8-43) as
    complex64: [..., S] -> [..., (S+2)*N*osr], built from the planar
    emitter's planes (bit-equal to them, as in the JAX twin).
    ``phase_carry=False`` starts every symbol chirp at phase 0 (the
    gr-lora_sdr per-symbol-independent modulator)."""
    return torch.complex(*modulate_symbols_planar(
        symbols, sf, osr, bw_scale, ampl, sync_word, continuous, phase_carry))


def base_downchirp(sf: int, bw_scale: float = 1.0, osr: int = 1,
                   device=None) -> torch.Tensor:
    """The canonical dechirp reference ``genChirp(N, osr, N*osr, 0, down)``
    as a complex64 [N*osr] tensor on ``device`` (default: the first CUDA
    card), from the float64 host oracle of :func:`base_downchirp_planar`."""
    re, im = device_table(base_downchirp_planar, sf, bw_scale, osr,
                          device=device_of(None, device))
    return torch.complex(re, im)


@functools.lru_cache(maxsize=16)
def base_downchirp_planar(sf: int, bw_scale: float = 1.0, osr: int = 1):
    """(re, im) float32 NumPy planes of the canonical dechirp reference
    ``genChirp(N, osr, N*osr, 0, down)`` (reference: src/phy/phy.cpp:203-204,
    tests/e2e_chain_test.cpp:85-87)."""
    n = 1 << sf
    samples, _ = gen_chirp_np(n, osr, n * osr, 0.0, down=True, ampl=1.0,
                              phase0=0.0, bw_scale=bw_scale)
    return (np.ascontiguousarray(samples.real.astype(np.float32)),
            np.ascontiguousarray(samples.imag.astype(np.float32)))


@functools.lru_cache(maxsize=16)
def _model_up(sf: int) -> np.ndarray:
    n = 1 << sf
    idx = np.arange(n, dtype=np.float64)
    accum = np.cumsum(-math.pi + (2.0 * math.pi * idx) / n)
    return np.exp(1j * accum).astype(np.complex64)


def model_chirps(sf: int, device=None):
    """The pure-model up/down chirps of the AWGN executable spec
    (reference: tests/awgn_sweep.py:233-242):
    ``up = exp(j*cumsum(-pi + 2*pi*n/N))``, ``down = conj(up)``, as
    complex64 [N] tensors on ``device`` (default: the first CUDA card),
    built in float64 NumPy as the JAX twin's."""
    up = _model_up(sf)
    dev = device_of(None, device)
    return (torch.from_numpy(up.copy()).to(dev),
            torch.from_numpy(np.conj(up)).to(dev))


@functools.lru_cache(maxsize=16)
def model_chirps_planar(sf: int):
    """Planar (re, im float32 NumPy) variant of :func:`model_chirps`."""
    n = 1 << sf
    idx = np.arange(n, dtype=np.float64)
    accum = np.cumsum(-math.pi + (2.0 * math.pi * idx) / n)
    return (np.cos(accum).astype(np.float32), np.sin(accum).astype(np.float32))
