"""Port parity: lora_phy_tpu_torch.ops.chirp (the integer-lattice TX
emitter) against lora_phy_tpu.ops.chirp on the same numpy-seeded symbols.

The table-gather emitter and the integer lattice are bit-equal by
construction (same NumPy tables, same int32 arithmetic, same float32
multiply). The trig emitter (tables over the 16 MB budget, e.g. SF11 at
osr 1) evaluates the same float32 phases with torch's and XLA's own
float32 cos/sin, which may differ in the last bits: held to 5e-7, about
four float32 ulps at magnitude 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import nn, tt, tparams
from lora_phy_tpu.models import modem as jmodem
from lora_phy_tpu.ops import chirp as jchirp
from lora_phy_tpu.utils.params import Bandwidth, LoraParams
from lora_phy_tpu_torch.models import modem as tmodem
from lora_phy_tpu_torch.ops import chirp as tchirp
from lora_phy_tpu_torch.ops import planar as tplanar

TRIG_ATOL = 5e-7


def _symbols(p: LoraParams, shape, seed):
    # the aliased range [0, 2N): Hamming 8/4 symbols exceed N at SF7
    return np.random.RandomState(seed).randint(0, 2 * p.n, shape).astype(np.int32)


@pytest.mark.parametrize("sf,osr,bw,continuous,table", [
    (7, 1, Bandwidth.BW_125, False, True),
    (7, 2, Bandwidth.BW_125, True, True),
    (7, 2, Bandwidth.BW_250, False, True),
    (11, 1, Bandwidth.BW_125, False, False),
])
def test_tx_planes_vs_jax(sf, osr, bw, continuous, table):
    p = LoraParams(sf=sf, osr=osr, bw=bw, continuous_chirp=continuous)
    bw8 = int(round(p.scale * 8))
    assert (jchirp._mod_chirp_tables(p.n, osr, bw8, continuous) is not None) == table
    syms = _symbols(p, (2, 3, 5), seed=sf + osr)
    args = (sf, osr, p.scale, 0.75, p.sync_word, continuous)
    jr, ji = jchirp.modulate_symbols_planar(syms, *args)
    tr, ti = tchirp.modulate_symbols_planar(tt(syms), *args)
    assert tr.dtype == torch.float32 and tuple(tr.shape) == jr.shape
    if table:
        np.testing.assert_array_equal(nn(tr), nn(jr))
        np.testing.assert_array_equal(nn(ti), nn(ji))
    else:
        np.testing.assert_allclose(nn(tr), nn(jr), rtol=0, atol=TRIG_ATOL)
        np.testing.assert_allclose(nn(ti), nn(ji), rtol=0, atol=TRIG_ATOL)


@pytest.mark.parametrize("n,osr,bw8,continuous", [
    (128, 1, 8, False), (128, 2, 8, True), (256, 2, 4, False), (1024, 1, 8, False),
])
def test_chirp_phase_bit_equal(n, osr, bw8, continuous):
    syms = np.arange(2 * n, dtype=np.int32).reshape(4, -1)
    ref = nn(jchirp._chirp_phase(jnp.asarray(syms), n, osr, bw8, continuous))
    got = nn(tchirp._chirp_phase(tt(syms), n, osr, bw8, continuous))
    np.testing.assert_array_equal(got, ref)


def test_chirp_phase_wide_lattice_matches_wrapped_int32():
    """N*osr >= 46341: JAX lets the int32 lattice wrap (exact because the
    period divides 2^32); the port computes it in int64. Same phases."""
    n, osr, bw8 = 4096, 16, 8
    syms = np.array([[0, 4095, 5000]], np.int32)
    ref = nn(jchirp._chirp_phase(jnp.asarray(syms), n, osr, bw8))
    got = nn(tchirp._chirp_phase(tt(syms), n, osr, bw8))
    np.testing.assert_array_equal(got, ref)


def test_chirp_phase_guard_raises_like_jax():
    syms = np.zeros((1, 1), np.int32)
    with pytest.raises(ValueError):
        jchirp._chirp_phase(jnp.asarray(syms), 4096, 12, 8)
    with pytest.raises(ValueError, match="overflows the int32 phase lattice"):
        tchirp._chirp_phase(tt(syms), 4096, 12, 8)


@pytest.mark.parametrize("sf,osr,bw", [
    (7, 1, Bandwidth.BW_125), (7, 4, Bandwidth.BW_125),
    (9, 1, Bandwidth.BW_250), (12, 1, Bandwidth.BW_500),
])
def test_base_downchirp_planar_bit_equal(sf, osr, bw):
    p = LoraParams(sf=sf, osr=osr, bw=bw)
    for mine, ref in zip(tchirp.base_downchirp_planar(sf, p.scale, osr),
                         jchirp.base_downchirp_planar(sf, p.scale, osr)):
        assert mine.dtype == np.float32
        np.testing.assert_array_equal(mine, ref)


def test_gen_chirp_np_bit_equal():
    for args in [(128, 1, 300, 0.3, False), (256, 2, 700, 0.0, True, 0.5, 1.0, 2.0)]:
        mine, end = tchirp.gen_chirp_np(*args)
        ref, ref_end = jchirp.gen_chirp_np(*args)
        np.testing.assert_array_equal(mine, ref)
        assert end == ref_end


def test_modulate_complex_wrapper_vs_jax():
    p = LoraParams(sf=7)
    tp = tparams(p)
    payload = np.random.RandomState(2).randint(0, 256, (2, 9)).astype(np.uint8)
    ref = nn(jmodem.modulate(jmodem.encode(payload), p))
    got = tmodem.modulate(tmodem.encode(tt(payload)), tp)
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(nn(got), ref)
    re, im = tplanar.modulate_planar(tmodem.encode(tt(payload)), tp)
    assert re.shape == (2, 20 * p.step)
