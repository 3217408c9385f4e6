"""Port parity: lora_phy_tpu_torch.ops.channelizer (the polyphase analysis
and synthesis banks) against lora_phy_tpu.ops.channelizer on the same
numpy-seeded inputs.

Outputs agree within atol 1e-5, JAX's own gate between its planar and
complex banks (tests/test_channelizer.py:121-160): float32 sums of
``2*taps*K`` terms in another order (a strided convolution here, a
grouped matmul or einsums there). The NumPy tables are bit-equal.
"""

import numpy as np
import pytest
import torch

from _torch_util import nn, tparams, tt
from lora_phy_tpu.models import modem as jmodem
from lora_phy_tpu.models import stream as jstream
from lora_phy_tpu.ops import channelizer as jchan
from lora_phy_tpu.utils.params import LoraParams
from lora_phy_tpu_torch.models import modem as tmodem
from lora_phy_tpu_torch.models import sync as tsync
from lora_phy_tpu_torch.ops import channelizer as tchan

ATOL = 1e-5


def _cx(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def _planes(x):
    return (np.ascontiguousarray(x.real.astype(np.float32)),
            np.ascontiguousarray(x.imag.astype(np.float32)))


@pytest.mark.parametrize("k,taps", [(8, 7), (8, 15), (4, 1), (16, 3)])
def test_tables_bit_equal(k, taps):
    np.testing.assert_array_equal(tchan._prototype(k, taps), jchan._prototype(k, taps))
    np.testing.assert_array_equal(tchan._combined_bank_planar(k, taps),
                                  jchan._combined_bank_planar(k, taps))


@pytest.mark.parametrize("k,taps,t", [(8, 7, 4096), (8, 15, 4096 + 5), (4, 15, 1000),
                                      (16, 3, 2048)])
def test_channelize_planar_vs_jax(k, taps, t):
    """Against both JAX banks, planar and complex; a length that is not a
    multiple of K drops its tail, as JAX."""
    x = _cx((t,), k + taps)
    xr, xi = _planes(x)
    jr, ji = jchan.channelize_planar(xr, xi, k, taps)
    gr, gi = tchan.channelize_planar(tt(xr), tt(xi), k, taps)
    assert gr.shape == gi.shape == (k, t // k) and gr.dtype == torch.float32
    np.testing.assert_allclose(nn(gr), np.asarray(jr), rtol=0, atol=ATOL)
    np.testing.assert_allclose(nn(gi), np.asarray(ji), rtol=0, atol=ATOL)
    ref = np.asarray(jchan.channelize(x, k, taps))
    got = nn(tchan.channelize(torch.from_numpy(x), k, taps))
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_channelize_batched_vs_jax():
    """Leading batch dims flow through the bank; each row equals its own
    single-row call."""
    k = 8
    x = _cx((3, 2, 2048), 0)
    xr, xi = _planes(x)
    gr, gi = tchan.channelize_planar(tt(xr), tt(xi), k)
    assert gr.shape == (3, 2, k, 2048 // k)
    jr, ji = jchan.channelize_planar(xr, xi, k)
    np.testing.assert_allclose(nn(gr), np.asarray(jr), rtol=0, atol=ATOL)
    np.testing.assert_allclose(nn(gi), np.asarray(ji), rtol=0, atol=ATOL)
    one = tchan.channelize_planar(tt(xr[1, 0]), tt(xi[1, 0]), k)
    np.testing.assert_allclose(nn(gr[1, 0]), nn(one[0]), rtol=0, atol=ATOL)


def test_channelize_degenerate_group_size():
    """taps_per_branch=1 with k > 1024 (tests/test_channelizer.py's
    degenerate group-size case): the same outputs as JAX."""
    k, t = 2048, 8192
    x = _cx((t,), 3)
    xr, xi = _planes(x)
    jr, ji = jchan.channelize_planar(xr, xi, k, taps_per_branch=1)
    gr, gi = tchan.channelize_planar(tt(xr), tt(xi), k, taps_per_branch=1)
    assert gr.shape == (k, t // k)
    np.testing.assert_allclose(nn(gr), np.asarray(jr), rtol=0, atol=ATOL)
    np.testing.assert_allclose(nn(gi), np.asarray(ji), rtol=0, atol=ATOL)


def test_even_taps_raise():
    x = torch.zeros(64)
    for fn in (lambda: tchan.channelize_planar(x, x, 4, 6),
               lambda: tchan.synthesize_channels_planar(x[None], x[None], 4, 6)):
        with pytest.raises(ValueError, match="odd"):
            fn()


@pytest.mark.parametrize("k,taps,c", [(8, 7, 3), (4, 15, 4), (8, 1, 8)])
def test_synthesize_channels_planar_vs_jax(k, taps, c):
    ch = _cx((c, 64), 10 + c)
    sr, si = _planes(ch)
    jr, ji = jchan.synthesize_channels_planar(sr, si, k, taps)
    gr, gi = tchan.synthesize_channels_planar(tt(sr), tt(si), k, taps)
    assert gr.shape == (64 * k,)
    np.testing.assert_allclose(nn(gr), np.asarray(jr), rtol=0, atol=ATOL)
    np.testing.assert_allclose(nn(gi), np.asarray(ji), rtol=0, atol=ATOL)
    ref = np.asarray(jchan.synthesize_channels(ch, k, taps))
    got = nn(tchan.synthesize_channels(torch.from_numpy(ch), k, taps))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    batched = tchan.synthesize_channels_planar(tt(np.stack([sr, sr])),
                                               tt(np.stack([si, si])), k, taps)
    np.testing.assert_allclose(nn(batched[0][1]), nn(gr), rtol=0, atol=ATOL)


def test_synthesize_tone_channels_vs_jax():
    ch = _cx((3, 50), 4)
    ref = np.asarray(jchan.synthesize_tone_channels(ch, 4))
    got = nn(tchan.synthesize_tone_channels(torch.from_numpy(ch), 4))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_synthesis_then_analysis_recovers_each_channel():
    """Each of K band-limited streams (tones within 0.3 of the channel
    rate) goes through the synthesis bank and comes back from the
    analysis bank on its own channel, sample-aligned, the others at least
    40 dB down (the prototype's stopband)."""
    k, frames, taps = 8, 2048, 15
    rng = np.random.RandomState(9)
    m = np.arange(frames)
    ch = np.zeros((k, frames), np.complex64)
    for c in range(k):
        for f, a in zip(rng.uniform(-0.3, 0.3, 3), rng.randn(3) + 1j * rng.randn(3)):
            ch[c] += (a * np.exp(2j * np.pi * f * m)).astype(np.complex64)
    sr, si = _planes(ch)
    wr, wi = tchan.synthesize_channels_planar(tt(sr), tt(si), k, taps)
    cr, ci = tchan.channelize_planar(wr, wi, k, taps)
    got = nn(cr) + 1j * nn(ci)
    mid = slice(4 * taps, frames - 4 * taps)
    for c in range(k):
        err = np.abs(got[c, mid] - ch[c, mid]) ** 2
        assert 10 * np.log10(err.mean() / np.mean(np.abs(ch[c, mid]) ** 2)) < -20.0
    tone = np.zeros((k, frames), np.complex64)
    tone[5] = np.exp(2j * np.pi * 0.01 * m)
    tr, ti = _planes(tone)
    cr, ci = tchan.channelize_planar(*tchan.synthesize_channels_planar(tt(tr), tt(ti), k, taps),
                                     k, taps)
    power = (nn(cr) ** 2 + nn(ci) ** 2)[:, mid].mean(-1)
    assert power[5] > 1e4 * (power.sum() - power[5])


def test_multichannel_lora_receive():
    """tests/test_channelizer.py's two-transmission case through the port:
    synthesis -> analysis -> the block receiver on each occupied channel,
    both payloads exact at their start."""
    k = 4
    p = LoraParams(sf=7)
    payloads = {1: np.arange(16, dtype=np.uint8), 3: np.arange(16, dtype=np.uint8)[::-1]}
    F = 600 + jstream.frame_modulate(jmodem.encode(payloads[1]), p).shape[-1] + 600
    sr = np.zeros((k, F), np.float32)
    si = np.zeros((k, F), np.float32)
    for c, pay in payloads.items():
        f = np.asarray(jstream.frame_modulate(jmodem.encode(pay), p))
        sr[c, 600: 600 + f.size], si[c, 600: 600 + f.size] = f.real, f.imag
    wr, wi = tchan.synthesize_channels_planar(tt(sr), tt(si), k, taps_per_branch=15)
    cr, ci = tchan.channelize_planar(wr, wi, k, taps_per_branch=15)
    for c, pay in payloads.items():
        blk = tsync.receive_block_planar(cr[c], ci[c], tparams(p), 32, max_frames=1)
        assert bool(blk.found[0]) and int(blk.start[0]) == 600
        np.testing.assert_array_equal(nn(tmodem.decode(blk.symbols[0])), pay)
