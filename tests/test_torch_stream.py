"""Port parity: lora_phy_tpu_torch.models.stream (frame synthesis and the
block-wise stream receiver) against lora_phy_tpu.models.stream.

Frame planes are bit-equal (the same lattice emitter and host oracle).
``BatchStreamDemodulator`` reports the same frames as JAX's over the same
blocks — absolute start, symbols, sync word and integer CFO — including
the carry of frames beyond ``max_frames`` and a stream that JAX's
demodulator began and the port resumes from its carry."""

import numpy as np
import pytest
import torch

from _torch_util import nn, tparams, tt
from lora_phy_tpu.models import modem as jmodem
from lora_phy_tpu.models import stream as jstream
from lora_phy_tpu.utils.params import Bandwidth, LoraParams
from lora_phy_tpu_torch.models import modem as tmodem
from lora_phy_tpu_torch.models import stream as tstream

N_PAYLOAD = 8


@pytest.mark.parametrize("preamble_len", [6, 8, 10])
@pytest.mark.parametrize("p", [LoraParams(sf=7), LoraParams(sf=9, osr=2)],
                         ids=["sf7", "sf9_osr2"])
def test_frame_overhead_samples_vs_jax(p, preamble_len):
    assert tstream.frame_overhead_samples(tparams(p), preamble_len) == \
        jstream.frame_overhead_samples(p, preamble_len)
    assert tstream.QUARTER_DEN == jstream.QUARTER_DEN


@pytest.mark.parametrize("p,preamble_len,amplitude", [
    (LoraParams(sf=7), 8, 1.0),
    (LoraParams(sf=7, osr=2, continuous_chirp=True), 8, 1.0),
    (LoraParams(sf=7, bw=Bandwidth.BW_250), 10, 0.5),
    (LoraParams(sf=9, osr=2), 6, 1.0),
], ids=["sf7", "sf7_osr2_cont", "sf7_bw250", "sf9_osr2"])
def test_frame_modulate_planar_bit_equal(p, preamble_len, amplitude):
    syms = nn(jmodem.encode(np.random.RandomState(p.sf).randint(
        0, 256, (2, 3, 4)).astype(np.uint8))).astype(np.int32)
    ref = jstream.frame_modulate_planar(syms, p, preamble_len, amplitude)
    got = tstream.frame_modulate_planar(tt(syms), tparams(p), preamble_len, amplitude)
    overhead = jstream.frame_overhead_samples(p, preamble_len)
    for mine, theirs in zip(got, ref):
        assert mine.dtype == torch.float32
        assert tuple(mine.shape) == (2, 3, overhead + 8 * p.step)
        np.testing.assert_array_equal(nn(mine), nn(theirs))


def test_frame_modulate_planar_sync_symbols_bit_equal():
    """A per-frame sync word given as symbols overrides params.sync_word;
    an array input needs device=."""
    p = LoraParams(sf=7)
    syms = np.random.RandomState(3).randint(0, 256, (2, 6)).astype(np.int32)
    sync_syms = np.array([[8, 16], [64, 120]], np.int32)
    ref = jstream.frame_modulate_planar(syms, p, sync_symbols=sync_syms)
    got = tstream.frame_modulate_planar(syms, tparams(p), sync_symbols=sync_syms,
                                        device="cpu")
    for mine, theirs in zip(got, ref):
        np.testing.assert_array_equal(nn(mine), nn(theirs))


def _stream(p, count, gaps, seed, lead=300):
    """One channel of ``count`` frames separated by ``gaps`` samples, as
    float32 numpy planes, and the payloads."""
    rng = np.random.RandomState(seed)
    payloads = rng.randint(0, 256, (count, N_PAYLOAD // 2)).astype(np.uint8)
    fr, fi = jstream.frame_modulate_planar(
        nn(jmodem.encode(payloads)).astype(np.int32), p)
    fr, fi = nn(fr), nn(fi)
    length = fr.shape[-1]
    total = lead + count * length + sum(gaps) + 4 * p.step
    xr = np.zeros(total, np.float32)
    xi = np.zeros(total, np.float32)
    pos = lead
    for k in range(count):
        xr[pos:pos + length], xi[pos:pos + length] = fr[k], fi[k]
        pos += length + gaps[k]
    return xr, xi, payloads


def _run_jax(demod, st, xr, xi, block):
    got = []
    for off in range(0, xr.size, block):
        st, out = demod.process(st, xr[off:off + block], xi[off:off + block])
        got.extend(out)
    return st, got


def _run_torch(demod, st, xr, xi, block, start=0):
    got = []
    for off in range(start, xr.size, block):
        st, out = demod.process(st, tt(xr[off:off + block]), tt(xi[off:off + block]))
        got.extend(out)
    return st, got


def _assert_same_frames(got, ref):
    assert len(got) == len(ref)
    for (s, syms, sync, cfo), (rs, rsyms, rsync, rcfo) in zip(got, ref):
        assert (s, sync, cfo) == (rs, rsync, rcfo)
        assert isinstance(syms, torch.Tensor) and syms.dtype == torch.int32
        np.testing.assert_array_equal(nn(syms), np.asarray(rsyms).astype(np.int32))


def test_batch_stream_demodulator_vs_jax():
    """Five frames at irregular gaps, fed in blocks of twice a frame
    length: every frame once, at its absolute start, across the seams."""
    p = LoraParams(sf=7)
    rng = np.random.RandomState(10)
    gaps = [5 * p.step + int(rng.randint(0, p.step)) for _ in range(5)]
    xr, xi, payloads = _stream(p, 5, gaps, seed=10)
    jdemod = jstream.BatchStreamDemodulator(p, N_PAYLOAD, max_frames=4)
    tdemod = tstream.BatchStreamDemodulator(tparams(p), N_PAYLOAD, max_frames=4,
                                            device="cpu")
    block = 2 * tdemod.frame_len
    jst, ref = _run_jax(jdemod, jdemod.init_state(), xr, xi, block)
    tst, got = _run_torch(tdemod, tdemod.init_state(), xr, xi, block)
    _assert_same_frames(got, ref)
    assert len(got) == 5 and tst.consumed == jst.consumed
    np.testing.assert_array_equal(nn(tst.tail_re), jst.tail_re)
    for (_, syms, sync, _), pl in zip(got, payloads):
        assert sync == p.sync_word
        np.testing.assert_array_equal(nn(tmodem.decode(syms)), pl)


def test_batch_stream_demodulator_overflow_frames_carry():
    """More frames in a block than max_frames: the rest carries to the
    next call (here one with an empty block), as in JAX."""
    p = LoraParams(sf=7)
    xr, xi, payloads = _stream(p, 4, [2 * p.step] * 4, seed=11, lead=50)
    jdemod = jstream.BatchStreamDemodulator(p, N_PAYLOAD, max_frames=2)
    tdemod = tstream.BatchStreamDemodulator(tparams(p), N_PAYLOAD, max_frames=2,
                                            device="cpu")
    jst, ref1 = jdemod.process(jdemod.init_state(), xr, xi)
    tst, got1 = tdemod.process(tdemod.init_state(), tt(xr), tt(xi))
    _assert_same_frames(got1, ref1)
    assert len(got1) == 2
    empty = np.zeros(0, np.float32)
    _, ref2 = jdemod.process(jst, empty, empty)
    _, got2 = tdemod.process(tst, tt(empty), tt(empty))
    _assert_same_frames(got2, ref2)
    assert len(got2) == 2
    for (_, syms, _, _), pl in zip(got1 + got2, payloads):
        np.testing.assert_array_equal(nn(tmodem.decode(syms)), pl)


def test_batch_stream_resumes_from_jax_state():
    """JAX's demodulator takes the first blocks; the port takes its carry
    through PlanarStreamState.from_numpy and reports the remaining frames
    exactly as JAX's own continuation does."""
    p = LoraParams(sf=7)
    xr, xi, _ = _stream(p, 5, [3 * p.step + 17 * k for k in range(5)], seed=12)
    jdemod = jstream.BatchStreamDemodulator(p, N_PAYLOAD, max_frames=4)
    tdemod = tstream.BatchStreamDemodulator(tparams(p), N_PAYLOAD, max_frames=4,
                                            device="cpu")
    block = 2 * tdemod.frame_len
    split = 2 * block
    jst, first = _run_jax(jdemod, jdemod.init_state(), xr[:split], xi[:split], block)
    assert 0 < len(first) < 5
    _, ref = _run_jax(jdemod, jst, xr[split:], xi[split:], block)
    state = tstream.PlanarStreamState.from_numpy(jst.tail_re, jst.tail_im,
                                                 jst.consumed, device="cpu")
    _, got = _run_torch(tdemod, state, xr[split:], xi[split:], block)
    _assert_same_frames(got, ref)
    assert len(first) + len(got) == 5


def test_planar_stream_state_from_numpy(monkeypatch):
    tail = np.arange(5, dtype=np.float64)
    st = tstream.PlanarStreamState.from_numpy(tail, -tail, np.int64(77), device="cpu")
    assert st.tail_re.dtype == torch.float32 and st.tail_re.device.type == "cpu"
    assert isinstance(st.consumed, int) and st.consumed == 77
    np.testing.assert_array_equal(nn(st.tail_im), -tail.astype(np.float32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstream.PlanarStreamState.from_numpy(tail, tail, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstream.BatchStreamDemodulator(tparams(LoraParams()), 8).init_state()
