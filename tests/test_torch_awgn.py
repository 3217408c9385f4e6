"""Port parity: lora_phy_tpu_torch.models.awgn (the AWGN Monte Carlo),
``ops/chirp.py``'s model chirps and the port's ``utils/{profiles,stats}.py``
against the JAX package.

The bit helpers, the tone tables and the model chirps are bit-equal. The
planar and complex SNR points, fed the payloads and noise that JAX's own
``_simulate_point_planar`` / ``_simulate_point`` draw from a PRNGKey
(split as the JAX twin splits it; the draws made under ``jax.jit``), give
error counts equal to JAX's. The statistical gates of
``tests/test_awgn.py`` are rerun on the port with its ``torch.Generator``
draws."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import nn, tt
from lora_phy_tpu.models import awgn as jawgn
from lora_phy_tpu.ops import chirp as jchirp
from lora_phy_tpu.utils import profiles as jprofiles
from lora_phy_tpu_torch.models import awgn, modem
from lora_phy_tpu_torch.ops import chirp as tchirp
from lora_phy_tpu_torch.ops.impair import apply_awgn
from lora_phy_tpu_torch.utils.profiles import DEFAULT_PROFILES, load_profiles

CRS = ["4/5", "4/6", "4/7", "4/8"]
CPU = torch.device("cpu")


def _cpu_gen(seed):
    return torch.Generator(device=CPU).manual_seed(seed)


# ---------------------------------------------------------------------------
# Bit helpers, tables, chirps: bit-equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cr", CRS)
def test_payload_bits_roundtrip_vs_jax(cr):
    rng = np.random.RandomState(1)
    payload = rng.randint(0, 256, (5, 11)).astype(np.uint8)
    jb = np.asarray(jawgn.encode_payload_bits(payload, cr))
    tb = nn(awgn.encode_payload_bits(tt(payload), cr))
    np.testing.assert_array_equal(tb, jb)
    # corrupt bits so the decoders correct / pass errors as JAX's do
    flips = rng.rand(*jb.shape) < 0.03
    noisy = (jb ^ flips).astype(np.int32)
    np.testing.assert_array_equal(
        nn(awgn.decode_payload_bits(tt(noisy), cr, 11)),
        np.asarray(jawgn.decode_payload_bits(jnp.asarray(noisy), cr, 11)))
    np.testing.assert_array_equal(nn(awgn.decode_payload_bits(tt(jb), cr, 11)), payload)


@pytest.mark.parametrize("sf", [7, 8, 9, 10, 11, 12])
def test_symbol_bits_vs_jax(sf):
    rng = np.random.RandomState(sf)
    for nbits in (160, 161, 7 * sf + 3):
        bits = rng.randint(0, 2, (3, nbits)).astype(np.int32)
        js = np.asarray(jawgn.bits_to_symbols(jnp.asarray(bits), sf))
        ts = nn(awgn.bits_to_symbols(tt(bits), sf))
        np.testing.assert_array_equal(ts, js.astype(np.int32))
        np.testing.assert_array_equal(
            nn(awgn.symbols_to_bits(tt(js.astype(np.int32)), sf, nbits)),
            np.asarray(jawgn.symbols_to_bits(jnp.asarray(js), sf, nbits)))


@pytest.mark.parametrize("sf", [7, 8, 9, 10, 11, 12])
def test_tables_and_model_chirps_vs_jax(sf):
    n = 1 << sf
    for a, b in zip(awgn._tone_tables(n), jawgn._tone_tables(n)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tchirp.model_chirps_planar(sf), jchirp.model_chirps_planar(sf)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tchirp.model_chirps(sf, device="cpu"), jchirp.model_chirps(sf)):
        assert a.dtype == torch.complex64 and a.device == CPU
        np.testing.assert_array_equal(nn(a), np.asarray(b))


def test_profiles_and_wilson_copies_vs_jax():
    from lora_phy_tpu.utils.stats import wilson as jwilson
    from lora_phy_tpu_torch.utils.stats import wilson

    yaml = pathlib.Path(__file__).resolve().parents[1] / "profiles" / "perf_matrix.yaml"
    ours, theirs = load_profiles(yaml), jprofiles.load_profiles(yaml)
    assert [vars(p) for p in ours] == [vars(p) for p in theirs]
    assert [vars(p) for p in DEFAULT_PROFILES] == [vars(p) for p in jprofiles.DEFAULT_PROFILES]
    for p, q in zip(ours, theirs):
        assert p.cr_index == q.cr_index
        assert vars(p.params()) == vars(q.params())
    for k, n in ((0, 0), (0, 100), (37, 100), (100, 100), (500, 1000)):
        assert wilson(k, n) == jwilson(k, n)


# ---------------------------------------------------------------------------
# One SNR point on JAX's own draws: equal error counts
# ---------------------------------------------------------------------------

def _jax_draws(key, sf, cr, packets, payload_len, planar: bool):
    """The payload and unit-variance noise planes the JAX twin's point
    function draws from ``key`` (split as it splits it), drawn under
    jax.jit as there."""
    def draws(key):
        if planar:
            kp, kr, ki = jax.random.split(key, 3)
        else:
            kp, kn = jax.random.split(key)
            kr, ki = jax.random.split(kn)
        payload = jax.random.randint(kp, (packets, payload_len), 0, 256,
                                     jnp.int32).astype(jnp.uint8)
        nsym = -(-jawgn.encode_payload_bits(payload, cr).shape[-1] // sf)
        shape = (packets, nsym, 1 << sf)
        return (payload, jax.random.normal(kr, shape, jnp.float32),
                jax.random.normal(ki, shape, jnp.float32))

    return [np.asarray(a) for a in jax.jit(draws)(key)]


@pytest.mark.parametrize("planar", [True, False], ids=["planar", "complex"])
@pytest.mark.parametrize("sf,cr,snr,packets,payload_len", [
    (7, "4/5", -11.0, 64, 8),
    (7, "4/7", -10.0, 64, 8),
    (8, "4/8", -14.0, 32, 16),
    (9, "4/6", -16.0, 16, 8),
    (7, "4/8", 12.0, 16, 16),
])
def test_point_error_counts_on_jax_draws(planar, sf, cr, snr, packets, payload_len):
    key = jax.random.PRNGKey(sf * 100 + int(-snr))
    payload, nr, ni = _jax_draws(key, sf, cr, packets, payload_len, planar)
    jfn = jawgn._simulate_point_planar if planar else jawgn._simulate_point
    tfn = awgn._simulate_point_planar if planar else awgn._simulate_point
    jb, jp = (int(v) for v in jfn(key, snr, sf, cr, packets, payload_len))
    tb, tp = tfn(snr, sf, cr, packets, payload_len, payload=tt(payload),
                 noise=(tt(nr), tt(ni)), device="cpu")
    assert (int(tb), int(tp)) == (jb, jp)
    if snr < 0:
        assert jp > 0                   # the point exercises the decoders


def test_point_draws_from_generator():
    """Without injected draws the point draws payload, then the real and
    imaginary noise planes, from the generator: the same seed gives the
    same counts, and the injected equivalents reproduce them."""
    a = awgn._simulate_point_planar(-10.0, 7, "4/5", 32, 8, _cpu_gen(5))
    b = awgn._simulate_point_planar(-10.0, 7, "4/5", 32, 8, _cpu_gen(5))
    assert [int(x) for x in a] == [int(x) for x in b]
    g = _cpu_gen(5)
    payload = torch.randint(0, 256, (32, 8), generator=g, dtype=torch.int32).to(torch.uint8)
    shape = (32, -(-80 // 7), 128)               # 8 bytes at CR 4/5: 80 bits
    nr = torch.randn(shape, generator=g)
    ni = torch.randn(shape, generator=g)
    c = awgn._simulate_point_planar(-10.0, 7, "4/5", 32, 8, payload=payload,
                                    noise=(nr, ni), device="cpu")
    assert [int(x) for x in c] == [int(x) for x in a]


# ---------------------------------------------------------------------------
# tests/test_awgn.py's statistical gates on the port (torch.Generator draws)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", DEFAULT_PROFILES, ids=lambda p: p.name)
def test_model_error_free_at_12db(profile):
    pt = awgn.simulate(profile.sf, profile.cr, 12.0, packets=20, payload_len=16,
                       device="cpu")
    assert pt.per == 0.0 and pt.ber == 0.0


@pytest.mark.parametrize("profile", DEFAULT_PROFILES, ids=lambda p: p.name)
def test_model_fails_at_very_low_snr(profile):
    pt = awgn.simulate(profile.sf, profile.cr, -25.0, packets=10, payload_len=16,
                       device="cpu")
    assert pt.per > 0.5


def test_full_chain_error_free_at_12db():
    """The port's modem chain (encode/modulate/dechirp/demodulate/decode)
    through its AWGN injector at 12 dB."""
    for profile in DEFAULT_PROFILES:
        p = profile.params()
        payload = torch.arange(16, dtype=torch.uint8)
        dech = modem.dechirp(modem.modulate(modem.encode(payload), p), p)
        noisy = apply_awgn(_cpu_gen(0), dech, 12.0)
        res = modem.demodulate(noisy, p)
        np.testing.assert_array_equal(nn(modem.decode(res.symbols)), nn(payload))


def test_sweep_csv_schema(tmp_path):
    rows = awgn.sweep(DEFAULT_PROFILES[:1], snr_start=10.0, snr_stop=11.0,
                      snr_step=1.0, packets=4, payload_len=4, device="cpu")
    assert len(rows) == 2
    assert set(rows[0]) == {"sf", "bw", "cr", "snr_db", "ber", "per"}
    out = tmp_path / "awgn_sweep.csv"
    awgn.write_csv(rows, out)
    header = out.read_text().splitlines()[0]
    assert header == "sf,bw,cr,snr_db,ber,per"


def test_waterfall_monotone():
    pers = [
        awgn.simulate(7, "4/8", snr, packets=30, payload_len=8, seed=3, device="cpu").per
        for snr in (-20.0, -10.0, 0.0, 12.0)
    ]
    assert pers[0] >= pers[-1]
    assert pers[-1] == 0.0


def test_planar_simulation_matches_complex():
    clean_c = awgn.simulate(7, "4/8", 60.0, packets=12, payload_len=8, seed=2, device="cpu")
    clean_p = awgn.simulate_planar(7, "4/8", 60.0, packets=12, payload_len=8, seed=2,
                                   device="cpu")
    assert clean_c.per == clean_p.per == 0.0

    mid_c = awgn.simulate(7, "4/5", -13.0, packets=200, payload_len=8, seed=2, device="cpu")
    mid_p = awgn.simulate_planar(7, "4/5", -13.0, packets=200, payload_len=8, seed=2,
                                 device="cpu")
    assert abs(mid_c.per - mid_p.per) < 0.15


@pytest.mark.parametrize("cr", CRS)
def test_per_zero_at_12db_all_crs(cr):
    pt = awgn.simulate(7, cr, 12.0, packets=50, payload_len=16, seed=4, device="cpu")
    assert pt.per == 0.0 and pt.ber == 0.0


def test_per_close_to_jax_mid_snr():
    """Different draws, same model: at the SF7 knee the port's PER over
    400 packets lies within Monte Carlo tolerance of JAX's."""
    ours = awgn.simulate_planar(7, "4/5", -12.0, packets=400, payload_len=8, seed=1,
                                device="cpu").per
    theirs = jawgn.simulate_planar(7, "4/5", -12.0, packets=400, payload_len=8, seed=1).per
    assert 0.05 < theirs < 0.95
    assert abs(ours - theirs) < 0.12


def test_simulate_without_card_raises_when_no_device_given():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        awgn.simulate(7, "4/5", 0.0, packets=2, payload_len=2)
