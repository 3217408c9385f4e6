"""Polyphase filter-bank channelizer, the wideband front end — the PyTorch
twin of ``lora_phy_tpu/ops/channelizer.py``.

One wideband IQ stream splits into K critically sampled sub-channels
(spacing fs/K); channel k is centred at ``k * fs / K`` (k mod K, so
negative offsets alias to high k), basebanded and decimated by K. The
prototype is the JAX twin's windowed-sinc lowpass (NumPy, copied), and
the output is group-delay aligned: with odd ``taps_per_branch`` output
frame ``m`` of a channel corresponds to input samples around ``m * K``,
so LoRa symbol timing survives channelization.

Analysis is one strided 1-D convolution over both planes: the polyphase
FIR and the K-point channel DFT fold into a ``[2K, 2, taps*K]`` weight
(the JAX twin's ``_combined_bank_planar``), applied at stride K, so the
output is already channel-major ``[..., 2K, F]`` and no ``[F, taps*K]``
window matrix is made. Synthesis is the transpose: an IDFT across
channels, then a per-branch (grouped) convolution along frames with the
time-reversed prototype, then the commutator interleave. The JAX twin's
TPU layout tuning (its 128-lane group size and block-Toeplitz banks) has
no counterpart here. TF32 is off (package import), so both run in
float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import device_table
from .planar import as_planes


@functools.lru_cache(maxsize=16)
def _prototype(k: int, taps_per_branch: int) -> np.ndarray:
    """Windowed-sinc lowpass prototype, cutoff at half the channel spacing,
    shaped [taps_per_branch, K] (polyphase decomposition)."""
    ntaps = k * taps_per_branch
    t = np.arange(ntaps) - (ntaps - 1) / 2.0
    h = np.sinc(t / k) * np.hamming(ntaps)
    h /= h.sum()
    return h.reshape(taps_per_branch, k).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _combined_bank(k: int, taps_per_branch: int):
    """FIR prototype and channel DFT folded into one weight pair:
    ``out[c] = sum_{t,k} h[t,k] * e^{-2pi j ck/K} * window[t,k]`` as two
    [taps*K, K] real matrices (cos and sin parts)."""
    h = _prototype(k, taps_per_branch)                     # [taps, K]
    kk = np.arange(k)
    cosd = np.cos(2 * np.pi * np.outer(kk, kk) / k).astype(np.float32)
    sind = np.sin(2 * np.pi * np.outer(kk, kk) / k).astype(np.float32)
    wc = (h[:, :, None] * cosd.T[None, :, :]).reshape(taps_per_branch * k, k)
    ws = (h[:, :, None] * sind.T[None, :, :]).reshape(taps_per_branch * k, k)
    return wc, ws


@functools.lru_cache(maxsize=16)
def _combined_bank_planar(k: int, taps_per_branch: int) -> np.ndarray:
    """Both planes and both output parts in one matrix:
    ``[Xr | Xi] @ [[wc, -ws], [ws, wc]] = [out_r | out_i]``,
    ``[2*taps*K, 2K]``."""
    wc, ws = _combined_bank(k, taps_per_branch)
    return np.block([[wc, -ws], [ws, wc]]).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _analysis_weight(k: int, taps_per_branch: int) -> np.ndarray:
    """:func:`_combined_bank_planar` as a ``conv1d`` weight
    ``[2K out, 2 planes, taps*K]``: output channel o (re of channel o for
    o < K, im of channel o-K above) over the plane's window."""
    bank = _combined_bank_planar(k, taps_per_branch)       # [2*tk, 2K]
    tk = taps_per_branch * k
    return np.ascontiguousarray(bank.T.reshape(2 * k, 2, tk))


@functools.lru_cache(maxsize=16)
def _synthesis_weight(k: int, taps_per_branch: int) -> np.ndarray:
    """Per-branch time-reversed prototype, scaled by K for the
    zero-stuffing gain, as a grouped ``conv1d`` weight ``[K, 1, taps]``."""
    h = _prototype(k, taps_per_branch) * k                 # [taps, K]
    return h[::-1].T[:, None, :].copy()


@functools.lru_cache(maxsize=16)
def _idft_planes(k: int):
    """cos / sin planes of ``e^{+2pi j c r / K}`` [K, K] float32."""
    cc = np.arange(k)
    ang = 2 * np.pi * np.outer(cc, cc) / k
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _check_taps(taps_per_branch: int) -> None:
    if taps_per_branch % 2 == 0:
        raise ValueError("taps_per_branch must be odd for aligned output")


def channelize_planar(xr, xi, k: int, taps_per_branch: int = 7, device=None):
    """``(re, im) [..., T]`` float32 -> ``(re, im) [..., K, T//K]``.

    Output frame m of every channel is the window of ``taps*K`` samples
    starting at ``m*K`` of the stream zero-padded by
    ``(taps-1)/2 * K`` in front, against the combined bank: one
    stride-K ``conv1d`` with 2 input planes and 2K output rows. Tensors
    are computed on where they live; arrays go to ``device`` (default
    the first CUDA card)."""
    _check_taps(taps_per_branch)
    xr, xi = as_planes(xr, xi, device)
    t = xr.shape[-1] // k * k
    frames = t // k
    lead = xr.shape[:-1]
    pad_head = ((taps_per_branch - 1) // 2) * k
    pad_tail = (taps_per_branch - 1) * k - pad_head
    x = torch.stack([xr[..., :t].reshape(-1, t), xi[..., :t].reshape(-1, t)], dim=1)
    x = F.pad(x, (pad_head, pad_tail))                     # [B, 2, t + (taps-1)K]
    w = device_table(_analysis_weight, k, taps_per_branch, device=x.device)
    out = F.conv1d(x, w, stride=k)                         # [B, 2K, frames]
    out = out.reshape(*lead, 2 * k, frames)
    return out[..., :k, :], out[..., k:, :]


def synthesize_channels_planar(sr, si, k: int, taps_per_branch: int = 7,
                               device=None):
    """The polyphase synthesis bank (TX side), the transpose of
    :func:`channelize_planar`: ``(re, im) [..., C, F]`` channel streams
    (C <= K, channel c centred at ``c * fs / K``) -> ``(re, im) [...,
    F*K]`` at rate fs. IDFT across channels -> K branch streams ->
    interpolating polyphase FIR (the analysis prototype times K, time
    reversed) -> commutator interleave; group-delay aligned with the
    analysis bank, so analysis after synthesis recovers each stream
    sample-aligned."""
    _check_taps(taps_per_branch)
    sr, si = as_planes(sr, si, device)
    nchan, frames = sr.shape[-2], sr.shape[-1]
    lead = sr.shape[:-2]
    if nchan < k:
        pad = (0, 0, 0, k - nchan)
        sr, si = F.pad(sr, pad), F.pad(si, pad)
    er, ei = device_table(_idft_planes, k, device=sr.device)
    # branch r of output frame m: sum_c X_c[m] e^{+2pi j c r / K}
    ur = torch.einsum("...cf,cr->...rf", sr, er) - torch.einsum("...cf,cr->...rf", si, ei)
    ui = torch.einsum("...cf,cr->...rf", sr, ei) + torch.einsum("...cf,cr->...rf", si, er)
    w = device_table(_synthesis_weight, k, taps_per_branch, device=sr.device)
    half = (taps_per_branch - 1) // 2

    def fir(u):                                            # [..., K, F]
        up = F.pad(u.reshape(-1, k, frames), (half, taps_per_branch - 1 - half))
        y = F.conv1d(up, w, groups=k)                      # [B, K, F]
        return y.swapaxes(-1, -2).reshape(*lead, frames * k)   # commutate

    return fir(ur), fir(ui)


def channelize(x: torch.Tensor, k: int, taps_per_branch: int = 7) -> torch.Tensor:
    """[..., T] wideband complex64 -> [..., K, T//K] channel streams: a
    complex64 wrapper over :func:`channelize_planar`."""
    return torch.complex(*channelize_planar(x.real, x.imag, k, taps_per_branch))


def synthesize_channels(signals: torch.Tensor, k: int,
                        taps_per_branch: int = 7) -> torch.Tensor:
    """[..., C, F] complex64 channel streams -> [..., F*K] wideband: a
    complex64 wrapper over :func:`synthesize_channels_planar`."""
    return torch.complex(*synthesize_channels_planar(
        signals.real, signals.imag, k, taps_per_branch))


def synthesize_tone_channels(signals: torch.Tensor, k: int) -> torch.Tensor:
    """Legacy test helper (TX side): zero-order-hold mix of each channel
    onto its carrier, images suppressed only by the hold's sinc roll-off.
    Prefer :func:`synthesize_channels` (the true polyphase synthesis
    bank)."""
    nchan, length = signals.shape[-2], signals.shape[-1]
    dev = signals.device
    t = torch.arange(length * k, device=dev)
    wide = torch.zeros(*signals.shape[:-2], length * k, dtype=torch.complex64,
                       device=dev)
    for c in range(nchan):
        up = torch.repeat_interleave(signals[..., c, :], k, dim=-1)  # hold
        carrier = torch.exp(2j * torch.pi * (c % k) * t / k).to(torch.complex64)
        wide = wide + up * carrier
    return wide / nchan
