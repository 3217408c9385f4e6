"""The bulk coded decoder at SF12, 500 kHz, CR 4/5 (the upstream's profile
``sf12_bw500_cr45``: the benchmark's configuration ``bulk-sf12-bw500-cr45``
and its traffic mix ``bulk-sf12-b3328``) on the exact float32 route, where
the per-symbol stage is the torch four-step at N = 4096, on the CPU.

- Agreement: ``dechirp_planar`` -> ``demodulate_planar(fused=False)`` ->
  ``decode_payload``, as ``phybench/paths/bulk_wide.py`` calls it, against
  the benchmark's plain float64 reference (``phybench/reference/
  bulk_wide.py``) on 2 x 8 frames of the cell's traffic, held to the cell's
  limits.
- Float32: the program's CFO and timing estimates are, bit for bit, the
  reference's own computed in float32 (what the cell's ``cfo_err_f32`` and
  ``to_err_f32`` hold it to).
- Parity: the same frames through the JAX package's ``demodulate_planar``:
  decisions, sync words and offsets equal.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from _torch_util import nn, tparams
from lora_phy_tpu.ops import planar as jplanar
from lora_phy_tpu.utils.params import LoraParams as JaxLoraParams
from lora_phy_tpu_torch import LoraParams
from lora_phy_tpu_torch.ops import planar
from phybench.paths import bulk_wide as pbulk
from phybench.reference import bulk_wide as rbulk
from phybench.reference.check import combine
from phybench.traffic import generator

BENCH = pathlib.Path(__file__).resolve().parents[1] / "phybench"
CPU = torch.device("cpu")
BATCH = [2, 8]
SEEDS = [2 ** 33 + 5, 2 ** 31 + 17]
# the TF32 control's smallest cfo_err (p99.9, bins) and to_err (p99.9,
# samples) at the cell's size on an H100; sound runs read up to 1.14e-8
# and 0.151
CFO_ERR_CONTROL, TO_ERR_CONTROL = 1.2e-8, 0.1646


def _json(*parts):
    return json.loads(BENCH.joinpath(*parts).read_text())


CONFIG = _json("configs", "bulk-sf12-bw500-cr45.json")
LIMITS = _json("workloads", "bulk-sf12-b3328.json")["limits"]


def frames(seed):
    traffic = dict(_json("traffic", "bulk-sf12-b3328.json"), batch=BATCH, pool=1)
    return generator.make_pool(CONFIG, traffic, seed, CPU)[0]


def test_path_keeps_the_chirp_of_the_sample_rate():
    """At osr 1 the bandwidth sets the sample rate only: the path's chirps
    are those of scale 1, whatever ``bw_hz`` says."""
    system = pbulk.System(CONFIG, CPU)
    assert system.params == LoraParams(sf=12, sync_word=CONFIG["sync_word"])
    assert system.params.scale == 1.0
    with pytest.raises(ValueError):
        pbulk.System(dict(CONFIG, osr=2), CPU)


@pytest.mark.parametrize("seed", SEEDS)
def test_sf12_bulk_agrees_with_the_plain_reference(seed):
    item = frames(seed)
    system = pbulk.System(CONFIG, CPU)
    handle = system.device(item)
    out = system.outputs(handle, system.readout(handle))
    nums = combine([rbulk.judge(item, out, rbulk.reference_outputs(item, CONFIG), CONFIG)])
    assert all(nums[k] <= lim for k, lim in LIMITS.items()), (nums, LIMITS)
    assert nums["frame_mismatch"] == 0 and nums["sym_gap"] == 0, nums
    # printed by the cell, not compared there (float32's representation of
    # the mean peak bin sets them): under the control's smallest readings
    assert nums["cfo_err"] < CFO_ERR_CONTROL and nums["to_err"] < TO_ERR_CONTROL, nums
    # every frame of the mix decodes to the bytes sent at these seeds
    sent = item.payloads.reshape(-1, item.payloads.shape[-1])
    assert np.array_equal(out["bytes"].reshape(sent.shape), sent)
    assert out["crc_ok"].all() and (out["sync"] == CONFIG["sync_word"]).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_sf12_bulk_demod_matches_the_jax_package(seed):
    item = frames(seed)
    p = JaxLoraParams(sf=12, sync_word=CONFIG["sync_word"])
    dr, di = planar.dechirp_planar(item.xr, item.xi, tparams(p))
    got = planar.demodulate_planar(dr, di, tparams(p), fused=False)
    ref = jplanar.demodulate_planar(nn(dr), nn(di), p)
    np.testing.assert_array_equal(nn(got.symbols), nn(ref.symbols).astype(np.int32))
    np.testing.assert_array_equal(nn(got.sync_word), nn(ref.sync_word))
    np.testing.assert_array_equal(nn(got.cfo), nn(ref.cfo))
    np.testing.assert_array_equal(nn(got.time_offset), nn(ref.time_offset))


@pytest.mark.parametrize("seed", SEEDS)
def test_sf12_bulk_estimates_are_the_float32_references(seed):
    """The exact float32 steps land on the same floats as the reference's
    float32 estimates: every frame's CFO and timing offset equal, though
    the DFTs differ (the torch four-step against the dense product)."""
    item = frames(seed)
    system = pbulk.System(CONFIG, CPU)
    res = system.device(item)[0]
    xr, xi = (x.reshape(-1, x.shape[-1]) for x in (item.xr, item.xi))
    cfo, t_off = rbulk.estimates(xr, xi, CONFIG, "f32")
    np.testing.assert_array_equal(nn(res.cfo).reshape(-1), cfo)
    np.testing.assert_array_equal(nn(res.time_offset).reshape(-1), t_off)
