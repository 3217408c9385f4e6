"""The block receiver at SF12 (EU868 DR0: the benchmark's configuration
``gw-eu868-dr0`` and its traffic mix ``gw-pool128-dr0``) on its circular
path, where every DFT is the torch four-step at N = 4096, on the CPU.

- Agreement: ``receive_block_planar`` with the host decode, as the
  benchmark calls it, against the benchmark's plain float64 reference
  (``phybench/reference/gateway.py``) on 4 channels x 2^20 samples, held
  to the cell's own limits.
- Parity: the port's ``receive_block_planar`` against the JAX package's
  on the same SF12 blocks (2 channels x 2^18 samples): decisions equal on
  every lane, found or not, and the float estimates within rounding.
- ``planar.fourstep`` opens under a profiler once per four-step DFT,
  inside a stage range of the receiver, and never at SF7.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_util import nn, tparams
from lora_phy_tpu.models import sync as jsync
from lora_phy_tpu.utils.params import LoraParams as JaxLoraParams
from lora_phy_tpu_torch import LoraParams
from lora_phy_tpu_torch.models import sync as tsync
from phybench.paths import gateway as pgateway
from phybench.reference import gateway as rgateway
from phybench.reference.check import combine
from phybench.traffic import generator

BENCH = pathlib.Path(__file__).resolve().parents[1] / "phybench"
CPU = torch.device("cpu")
CHANNELS = 4
# four-step DFTs of one circular call: the scan, six start probes, the
# preamble estimate, the sync and payload demod, the clock-drift estimate
FOURSTEP_CALLS = 10
# the port against the JAX package: float32 sums that torch and XLA take in
# another order (residual CFO in bins, SNR in dB, clock drift in ppm)
CFO_ATOL = 1e-6
SNR_ATOL_DB = 1e-4
SRO_ATOL_PPM = 1e-4
# the DR5 cell's snr_err limit: held here, where every frame is found at
# its start (the DR0 cell compares no snr_err)
SNR_ERR = 3.5e-5


def _json(*parts):
    return json.loads(BENCH.joinpath(*parts).read_text())


def block(config_name, traffic_name, seed, channels):
    cfg = _json("configs", f"{config_name}.json")
    traffic = dict(_json("traffic", f"{traffic_name}.json"), channels=channels, pool=1)
    return cfg, generator.make_pool(cfg, traffic, seed, CPU)[0]


@pytest.fixture(scope="module")
def dr0():
    return block("gw-eu868-dr0", "gw-pool128-dr0", 2 ** 33 + 5, CHANNELS)


@pytest.fixture(scope="module")
def dr5():
    return block("gw-eu868-dr5", "gw-pool2048", 2 ** 33 + 5, 2)


def receive(cfg, item):
    return tsync.receive_block_planar(
        item.xr, item.xi, LoraParams(sf=cfg["sf"], sync_word=cfg["sync_word"]),
        2 * cfg["payload_bytes"], max_frames=cfg["max_frames"],
        preamble_len=cfg["preamble_len"], min_power_db=cfg["min_power_db"])


@pytest.mark.parametrize("seed", [2 ** 33 + 5, 2 ** 31 + 17])
def test_sf12_gateway_agrees_with_the_plain_reference(seed):
    cfg, item = block("gw-eu868-dr0", "gw-pool128-dr0", seed, CHANNELS)
    system = pgateway.System(cfg, CPU)
    out = system.readout(system.device(item))
    nums = combine([rgateway.judge(item, out, rgateway.reference_outputs(item, cfg), cfg)])
    limits = _json("workloads", "gw-dr0-pool128.json")["limits"]
    assert nums["lane_mismatch"] == 0 and nums["decode_mismatch"] == 0, nums
    assert nums["cfo_err"] < limits["cfo_err"] and nums["sro_err"] < limits["sro_err"], nums
    assert nums["snr_err"] < SNR_ERR, nums
    # every frame sent is found at its start, with its bytes
    for c in range(CHANNELS):
        for start, payload in zip(item.starts[c], item.payloads[c]):
            hit = out["found"][c] & (np.abs(out["start"][c] - start) <= 1)
            assert np.any(np.all(out["bytes"][c][hit] == payload, axis=-1)), (c, start)


@pytest.mark.parametrize("seed", [2 ** 33 + 5, 2 ** 31 + 17])
def test_sf12_receiver_matches_the_jax_package(seed):
    cfg = dict(_json("configs", "gw-eu868-dr0.json"), block_samples=1 << 18)
    traffic = dict(_json("traffic", "gw-pool128-dr0.json"), channels=2, pool=1)
    item = generator.make_pool(cfg, traffic, seed, CPU)[0]
    p = JaxLoraParams(sf=cfg["sf"], sync_word=cfg["sync_word"])
    args = (2 * cfg["payload_bytes"], cfg["max_frames"])
    kw = dict(preamble_len=cfg["preamble_len"], min_power_db=cfg["min_power_db"])
    ref = jsync.receive_block_planar(nn(item.xr), nn(item.xi), p, *args, **kw)
    got = tsync.receive_block_planar(item.xr, item.xi, tparams(p), *args, **kw)
    ref, got = (type(r)(*(nn(f) for f in r)) for r in (ref, got))
    for f in ("found", "start", "cfo_bins", "sync", "time_offset"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    np.testing.assert_array_equal(got.symbols, ref.symbols.astype(np.int32))
    f = ref.found
    assert f.sum() == 2 and (ref.start[f] == item.starts.ravel()).all()
    np.testing.assert_allclose(got.cfo[f], ref.cfo[f], rtol=0, atol=CFO_ATOL)
    np.testing.assert_allclose(got.snr_db[f], ref.snr_db[f], rtol=0, atol=SNR_ATOL_DB)
    np.testing.assert_allclose(got.sro_ppm[f], ref.sro_ppm[f], rtol=0, atol=SRO_ATOL_PPM)


def test_fourstep_span_opens_inside_the_stages_at_sf12_only(dr0, dr5):
    def ranges(cfg, item):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            receive(cfg, item)
        return [e for e in prof.events() if e.name == "planar.fourstep"]

    spans = ranges(*dr0)
    assert len(spans) == FOURSTEP_CALLS
    stages = []
    for e in spans:
        p = e.cpu_parent
        while p is not None and p.name not in tsync.CIRCULAR_STAGES:
            p = p.cpu_parent
        stages.append(p.name if p is not None else None)
    assert stages == ["front", *["probes"] * 6, "estimator", "demod", "sro"]
    assert ranges(*dr5) == []
