"""The benchmark's plain reference and generator against the program, on
the CPU at small sizes: the coding chains, the modulator, the gateway
receiver and the bulk decoder, and the control's TF32 rounding.

Run: ``python -m pytest phybench/tests -q -p no:cacheprovider``.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from lora_phy_tpu_torch import LoraParams
from lora_phy_tpu_torch.models import coded, modem
from lora_phy_tpu_torch.ops import coding as tcoding
from lora_phy_tpu_torch.ops import planar
from phybench.paths import bulk as pbulk
from phybench.paths import gateway as pgateway
from phybench.reference import bulk as rbulk
from phybench.reference import coding, dft
from phybench.reference.check import combine
from phybench.reference import gateway as rgateway
from phybench.traffic import generator

HERE = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _json(*parts):
    return json.loads(HERE.joinpath(*parts).read_text())


@pytest.fixture(scope="module")
def gw_cfg():
    return _json("configs", "gw-eu868-dr5.json")


@pytest.fixture(scope="module")
def bulk_cfg():
    return _json("configs", "bulk-sf7-cr45.json")


def test_crc_and_whitening_match_the_program():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (64, 34), dtype=np.uint8)
    np.testing.assert_array_equal(
        coding.crc16_sx1272(data), tcoding.crc16_sx1272(torch.from_numpy(data)).numpy())
    np.testing.assert_array_equal(
        coding.whiten(data), tcoding.whiten_sx1272_lfsr(torch.from_numpy(data), 0, 4).numpy())


@pytest.mark.parametrize("cr", [1, 4])
def test_coded_chain_matches_the_program(cr):
    rng = np.random.default_rng(cr)
    pay = rng.integers(0, 256, (32, 32), dtype=np.uint8)
    cfg = coded.CodedConfig(sf=7, cr=cr)
    sym = coding.encode_coded(pay, 7, cr)
    np.testing.assert_array_equal(sym, coded.encode_payload(torch.from_numpy(pay), cfg).numpy())
    # one bin off in every frame's third symbol: both decoders agree
    bad = sym.copy()
    bad[:, 2] = (bad[:, 2] + 1) % 128
    got = coding.decode_coded(bad, 32, 7, cr)
    want = coded.decode_payload(torch.from_numpy(bad), 32, cfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_simple_chain_matches_the_program():
    rng = np.random.default_rng(3)
    pay = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    sym = coding.encode_simple(pay)
    np.testing.assert_array_equal(sym, modem.encode(torch.from_numpy(pay)).numpy())
    every = np.arange(256)[None, :]
    np.testing.assert_array_equal(coding.decode_simple(every),
                                  modem.decode(torch.from_numpy(every)).numpy())


def test_modulator_matches_the_programs_frames():
    """The generator's noiseless frame is the program's own TX frame (to
    float32 rounding): the same chirps, phases and layout."""
    from lora_phy_tpu_torch.models import stream

    cfg = {"sf": 7, "sync_word": 0x12, "preamble_len": 8, "coding": "simple", "payload_bytes": 4}
    sym = coding.encode_simple(np.array([[1, 2, 3, 250]], np.uint8))
    ph = generator.frame_phase(sym, cfg, CPU)
    want_r, want_i = stream.frame_modulate_planar(torch.from_numpy(sym), LoraParams(sf=7),
                                                  device="cpu")
    np.testing.assert_allclose(torch.cos(ph).numpy(), want_r.numpy(), atol=2e-5)
    np.testing.assert_allclose(torch.sin(ph).numpy(), want_i.numpy(), atol=2e-5)
    cfg_b = dict(cfg, preamble_len=0)
    ph = generator.frame_phase(sym, cfg_b, CPU)
    want_r, _ = planar.modulate_planar(torch.from_numpy(sym), LoraParams(sf=7))
    np.testing.assert_allclose(torch.cos(ph).numpy(), want_r.numpy(), atol=2e-5)


def test_same_seed_same_pool(gw_cfg):
    tr = dict(_json("traffic", "gw-pool2048.json"), channels=2, pool=1)
    a = generator.make_pool(gw_cfg, tr, 2 ** 33 + 1, CPU)[0]
    b = generator.make_pool(gw_cfg, tr, 2 ** 33 + 1, CPU)[0]
    c = generator.make_pool(gw_cfg, tr, 2 ** 33 + 2, CPU)[0]
    assert torch.equal(a.xr, b.xr) and np.array_equal(a.starts, b.starts)
    assert not torch.equal(a.xr, c.xr)
    assert a.xr.shape == c.xr.shape


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 7])
def test_gateway_program_agrees_with_reference(gw_cfg, seed):
    tr = dict(_json("traffic", "gw-pool2048.json"), channels=8, pool=1)
    item = generator.make_pool(gw_cfg, tr, seed, CPU)[0]
    system = pgateway.System(gw_cfg, CPU)
    out = system.outputs(None, system.readout(system.device(item)))
    ref = rgateway.receive(item.xr, item.xi, gw_cfg, "f64")
    numbers = combine([rgateway.judge(item, out, ref, gw_cfg)])
    assert out["found"].sum() >= 12
    assert numbers["lane_mismatch"] == 0 and numbers["sym_gap"] == 0
    assert numbers["decode_mismatch"] == 0
    assert numbers["cfo_err"] < 1e-5 and numbers["snr_err"] < 1e-4 and numbers["sro_err"] < 1e-2


def test_bulk_program_agrees_with_reference(bulk_cfg):
    tr = dict(_json("traffic", "bulk-b65536.json"), batch=[2, 256], pool=1)
    item = generator.make_pool(bulk_cfg, tr, 5, CPU)[0]
    system = pbulk.System(bulk_cfg, CPU)
    handle = system.device(item)
    out = system.outputs(handle, system.readout(handle))
    ref = rbulk.demodulate(item.xr.reshape(512, -1), item.xi.reshape(512, -1), bulk_cfg, "f64")
    numbers = combine([rbulk.judge(item, out, ref, bulk_cfg)])
    assert numbers["frame_mismatch"] == 0 and numbers["sym_gap"] == 0
    assert numbers["decode_mismatch"] == 0
    assert numbers["cfo_err"] < 1e-6 and numbers["to_err"] < 1e-2
    assert out["crc_ok"].mean() > 0.8


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -10], dtype=torch.float32)
    got = dft.tf32_round(x)
    # halfway cases round to even mantissas
    assert got.tolist() == [1.0, 1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10]
