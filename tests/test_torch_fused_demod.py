"""Port parity: lora_phy_tpu_torch.ops.fused_demod against the Pallas
kernel's wrapper lora_phy_tpu.ops.pallas_demod.fused_detect_rows (which
runs in interpret mode on the CPU), mirroring tests/test_pallas.py.

On CPU tensors the port's wrapper runs the kernel's plain PyTorch twin;
the CUDA kernel itself is checked against that twin only where a card
is present (marked ``gpu``)."""

import numpy as np
import pytest
import torch

from _torch_util import cuda_device, nn, tt, tparams
from lora_phy_tpu.models import modem as jmodem
from lora_phy_tpu.ops import pallas_demod as jfused
from lora_phy_tpu.ops import planar as jplanar
from lora_phy_tpu.utils.params import LoraParams, Window
from lora_phy_tpu_torch.models import modem as tmodem
from lora_phy_tpu_torch.ops import fused_demod as tfused
from lora_phy_tpu_torch.ops import planar as tplanar


def _case(p, payload_len=16, batch=None, seed=0):
    """Numpy-seeded payloads and their dechirped planes (JAX TX chain)."""
    rng = np.random.RandomState(seed)
    shape = (batch, payload_len) if batch else (payload_len,)
    payloads = rng.randint(0, 256, shape).astype(np.uint8)
    dech = np.asarray(jmodem.dechirp(jmodem.modulate(jmodem.encode(payloads), p), p))
    xr, xi = jplanar.split_complex(dech)
    return payloads, xr, xi


def _random_rows(p, b, seed):
    rng = np.random.RandomState(seed)
    xr = rng.randn(b, p.n).astype(np.float32)
    xi = rng.randn(b, p.n).astype(np.float32)
    start = rng.uniform(-300.0, 300.0, b).astype(np.float32)
    rate = rng.uniform(-0.5, 0.5, b).astype(np.float32)
    return xr, xi, start, rate


@pytest.mark.parametrize("sf", [5, 7])
def test_fused_matches_unfused(sf):
    p = LoraParams(sf=sf)
    tp = tparams(p)
    _, xr, xi = _case(p)
    ref = tplanar.demodulate_planar(tt(xr), tt(xi), tp, fused=False)
    got = tplanar.demodulate_planar(tt(xr), tt(xi), tp, fused=True)
    np.testing.assert_array_equal(nn(got.symbols), nn(ref.symbols))
    assert int(got.sync_word) == int(ref.sync_word)
    jax_fused = jplanar.demodulate_planar(xr, xi, p, fused=True)
    np.testing.assert_array_equal(nn(got.symbols),
                                  nn(jax_fused.symbols).astype(np.int32))


def test_fused_batched_decodes():
    p = LoraParams(sf=7)
    tp = tparams(p)
    payloads, xr, xi = _case(p, payload_len=8, batch=4)
    got = tplanar.demodulate_planar(tt(xr), tt(xi), tp, fused=True)
    np.testing.assert_array_equal(nn(tmodem.decode(got.symbols)), payloads)


def test_fused_windowed():
    p = LoraParams(sf=7, window=Window.HANN)
    tp = tparams(p)
    _, xr, xi = _case(p, payload_len=8)
    ref = tplanar.demodulate_planar(tt(xr), tt(xi), tp, fused=False)
    got = tplanar.demodulate_planar(tt(xr), tt(xi), tp, fused=True)
    np.testing.assert_array_equal(nn(got.symbols), nn(ref.symbols))


def test_fused_tie_break():
    """An alternating impulse train has bins 0 and N/2 exactly equal: the
    first maximum, bin 0, wins (the SF2 equal_power_bin_test generalised)."""
    p = LoraParams(sf=7)
    tp = tparams(p)
    x = torch.zeros(1, p.n)
    x[0, ::2] = 1.0
    bins = tfused.fused_detect_rows(x, torch.zeros(1, p.n), torch.zeros(1),
                                    torch.zeros(1), tp)
    assert bins.dtype == torch.int32 and int(bins[0]) == 0


@pytest.mark.parametrize("window", [Window.NONE, Window.HANN], ids=["none", "hann"])
@pytest.mark.parametrize("sf", [5, 6, 7])
def test_twin_matches_jax_kernel_on_random_rows(sf, window):
    """2000 noise rows at random start (up to +-300 rad) and rate: the
    plain twin's bins equal the Pallas kernel's (interpret mode) bins."""
    p = LoraParams(sf=sf, window=window)
    tp = tparams(p)
    xr, xi, start, rate = _random_rows(p, 2000, seed=10 * sf + int(window))
    ref = nn(jfused.fused_detect_rows(xr, xi, start, rate, p))
    got = tfused.fused_detect_rows(tt(xr), tt(xi), tt(start), tt(rate), tp)
    np.testing.assert_array_equal(nn(got), ref)


def test_fused_demod_start_phase_vs_jax():
    """fused_demod's per-symbol start = rate*(s*N + t_off/osr) over a
    [..., S, N] batch with nonzero rate and t_off, at osr 2."""
    p = LoraParams(sf=6, osr=2)
    tp = tparams(p)
    rng = np.random.RandomState(3)
    yr = rng.randn(2, 3, 7, p.n).astype(np.float32)
    yi = rng.randn(2, 3, 7, p.n).astype(np.float32)
    rate = rng.uniform(-0.2, 0.2, (2, 3)).astype(np.float32)
    t_off = rng.randint(-40, 40, (2, 3)).astype(np.int32)
    ref = nn(jfused.fused_demod(yr, yi, rate, t_off, p))
    got = tfused.fused_demod(tt(yr), tt(yi), tt(rate), tt(t_off), tp)
    assert got.shape == (2, 3, 7)
    np.testing.assert_array_equal(nn(got), ref)


@pytest.mark.parametrize("window", [Window.NONE, Window.HANN], ids=["none", "hann"])
@pytest.mark.parametrize("sf", [5, 7])
def test_dft_tables_bit_equal(sf, window):
    p = LoraParams(sf=sf, window=window)
    w = jmodem._window_table(p)
    key = tuple(w) if w is not None else None
    for mine, ref in zip(tfused._dft_tables(p.n, key), jfused._dft_tables(p.n, key)):
        np.testing.assert_array_equal(mine, ref)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    p = LoraParams(sf=8)
    tp = tparams(p)
    x = torch.zeros(4, p.n)
    z = torch.zeros(4)
    with pytest.raises(ValueError, match="N <= 128"):
        tfused.fused_detect_rows(x, x, z, z, tp)
    with pytest.raises(ValueError, match="N <= 128"):
        jfused.fused_detect_rows(nn(x), nn(x), nn(z), nn(z), p)
    p = LoraParams(sf=7)
    tp = tparams(p)
    x = torch.zeros(4, p.n)
    with pytest.raises(TypeError, match="float32"):
        tfused.fused_detect_rows(x.double(), x, z, z, tp)
    with pytest.raises(ValueError, match="shape"):
        tfused.fused_detect_rows(x, x, torch.zeros(3), z, tp)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [Window.NONE, Window.HANN], ids=["none", "hann"])
@pytest.mark.parametrize("sf", [5, 6, 7])
def test_cuda_kernel_matches_twin(sf, window):
    """The CUDA kernel against its plain twin on the card: equal bins on
    clean chirp rows; on noise rows a differing bin only where the twin's
    top two magnitudes are within 1e-5 relative (a float32 near-tie)."""
    dev = cuda_device()
    p = LoraParams(sf=sf, window=window)
    tp = tparams(p)
    _, xr, xi = _case(p, payload_len=24, batch=8)
    xr, xi = tt(xr).to(dev), tt(xi).to(dev)
    launches = tfused.LAUNCHES
    got = tplanar.demodulate_planar(xr, xi, tp, fused=True)
    assert tfused.LAUNCHES == launches + 1
    ref = tplanar.demodulate_planar(xr, xi, tp, fused=False)
    torch.testing.assert_close(got.symbols, ref.symbols, rtol=0, atol=0)

    rows = [tt(a).to(dev) for a in _random_rows(p, 4096, seed=sf)]
    k = tfused.fused_detect_rows(*rows, tp)
    r = tfused.fused_detect_rows_reference(*rows, tp)
    torch.cuda.synchronize()
    differ = (k != r).nonzero().flatten()
    if differ.numel():
        mag = tfused.reference_power(*(t[differ] for t in rows), tp)
        top2 = mag.topk(2, dim=-1).values
        assert bool(((top2[:, 0] - top2[:, 1]) <= 1e-5 * top2[:, 0]).all())
