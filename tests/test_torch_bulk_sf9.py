"""The bulk coded decoder at SF9, 250 kHz, CR 4/8 (the upstream's profile
``sf9_bw250_cr48``: the benchmark's configuration ``bulk-sf9-bw250-cr48``
and its traffic mix ``bulk-sf9-b13312``) on the exact float32 route, where
the per-symbol stage runs at N = 512 and the decoder corrects single
errors of its Hamming(8,4) codewords, on the CPU.

- Agreement: ``dechirp_planar`` -> ``demodulate_planar(fused=False)`` ->
  ``decode_payload``, as ``phybench/paths/bulk_wide.py`` calls it, against
  the benchmark's plain float64 reference (``phybench/reference/
  bulk_wide.py``) on 2 x 8 frames of the cell's traffic, held to the cell's
  limits; at these seeds a frame comes back with its bytes only because a
  flagged codeword was corrected.
- Parity: the same frames through the JAX package's ``demodulate_planar``:
  decisions, sync words and timing offsets equal, the CFO within one unit
  in the last place.
- The counter ``coded.CODEWORDS``: the codewords each call's FEC decodes,
  by CR (72 a frame at SF9 CR 4/8, 70 at SF7 CR 4/5).
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
from lora_phy_tpu_torch.models import coded
from lora_phy_tpu_torch.ops import planar
from phybench.paths import bulk_wide as pbulk
from phybench.reference import bulk_wide as rbulk
from phybench.reference.check import combine
from phybench.traffic import generator

BENCH = pathlib.Path(__file__).resolve().parents[1] / "phybench"
CPU = torch.device("cpu")
BATCH = [2, 8]
# at both seeds one frame of the 16 carries flagged codewords and still
# decodes to the bytes sent: the Hamming(8,4) decode corrected them
SEEDS = [2 ** 33 + 5, 2 ** 31 + 17]
# 32 bytes and 2 CRC bytes: 68 nibbles, 8 interleaver blocks of 9 codewords
# at SF9; 10 blocks of 7 at SF7
CODEWORDS_SF9, CODEWORDS_SF7 = 72, 70


def _json(*parts):
    return json.loads(BENCH.joinpath(*parts).read_text())


CONFIG = _json("configs", "bulk-sf9-bw250-cr48.json")
LIMITS = _json("workloads", "bulk-sf9-b13312.json")["limits"]


def frames(seed, config=CONFIG, mix="bulk-sf9-b13312.json"):
    traffic = dict(_json("traffic", mix), batch=BATCH, pool=1)
    return generator.make_pool(config, traffic, seed, CPU)[0]


def test_path_keeps_the_chirp_of_the_sample_rate():
    """At osr 1 the 250 kHz bandwidth sets the sample rate only: the path's
    chirps are those of scale 1, and its decoder is CR 4/8."""
    system = pbulk.System(CONFIG, CPU)
    assert system.params == LoraParams(sf=9, sync_word=CONFIG["sync_word"])
    assert system.params.scale == 1.0
    assert system.cfg == coded.CodedConfig(sf=9, cr=4, crc=True, whiten=True)


@pytest.mark.parametrize("seed", SEEDS)
def test_sf9_bulk_agrees_with_the_plain_reference(seed):
    item = frames(seed)
    system = pbulk.System(CONFIG, CPU)
    handle = system.device(item)
    out = system.outputs(handle, system.readout(handle))
    nums = combine([rbulk.judge(item, out, rbulk.reference_outputs(item, CONFIG), CONFIG)])
    assert all(nums[k] <= lim for k, lim in LIMITS.items()), (nums, LIMITS)
    assert nums["frame_mismatch"] == 0 and nums["sym_gap"] == 0, nums
    assert nums["decode_mismatch"] == 0, nums
    # the correcting path: a frame with flagged codewords whose bytes,
    # and CRC, are those sent
    sent = item.payloads.reshape(-1, item.payloads.shape[-1])
    right = np.all(out["bytes"].reshape(sent.shape) == sent, axis=-1)
    fec, ok = out["fec_errors"].reshape(-1), out["crc_ok"].reshape(-1)
    assert fec.sum() > 0
    assert np.any(right & (fec > 0) & ok), (fec, right)
    # every frame that keeps its CRC keeps its bytes at these seeds (one
    # frame of each, near -15 dB, loses both)
    assert np.array_equal(right, ok) and not ok.all(), (right, ok)


@pytest.mark.parametrize("seed", SEEDS)
def test_sf9_bulk_demod_matches_the_jax_package(seed):
    """Decisions, sync words and timing offsets equal; the CFO within one
    unit in the last place. At N = 512 the estimate's DFT is the torch
    four-step (16 x 32), whose float32 GEMM sums run in another order than
    XLA's: the sync pair's peak phases, and so the fine CFO, can land one
    float apart (one frame of the 16 at the second seed)."""
    item = frames(seed)
    p = JaxLoraParams(sf=9, sync_word=CONFIG["sync_word"])
    dr, di = planar.dechirp_planar(item.xr, item.xi, tparams(p))
    got = planar.demodulate_planar(dr, di, tparams(p), fused=False)
    ref = jplanar.demodulate_planar(nn(dr), nn(di), p)
    np.testing.assert_array_equal(nn(got.symbols), nn(ref.symbols).astype(np.int32))
    np.testing.assert_array_equal(nn(got.sync_word), nn(ref.sync_word))
    np.testing.assert_array_max_ulp(nn(got.cfo), nn(ref.cfo), maxulp=1)
    np.testing.assert_array_equal(nn(got.time_offset), nn(ref.time_offset))


def test_codewords_counts_each_call_by_cr(monkeypatch):
    """``coded.CODEWORDS`` adds, under the call's CR, the codewords its FEC
    decoded: frames x 72 for an SF9 CR 4/8 call, frames x 70 for an SF7
    CR 4/5 one, and nothing under any other CR."""
    monkeypatch.setattr(coded, "CODEWORDS", {})
    system = pbulk.System(CONFIG, CPU)
    system.device(frames(SEEDS[0]))
    assert coded.CODEWORDS == {4: 16 * CODEWORDS_SF9}
    system.device(frames(SEEDS[1]))
    assert coded.CODEWORDS == {4: 2 * 16 * CODEWORDS_SF9}
    sf7 = _json("configs", "bulk-sf7-cr45.json")
    cfg7 = coded.CodedConfig(sf=7, cr=sf7["cr"], crc=sf7["crc"], whiten=sf7["whiten"])
    item = frames(SEEDS[0], sf7, "bulk-b65536.json")
    p7 = LoraParams(sf=7, sync_word=sf7["sync_word"])
    dr, di = planar.dechirp_planar(item.xr, item.xi, p7)
    res = planar.demodulate_planar(dr, di, p7)
    coded.decode_payload(res.symbols, sf7["payload_bytes"], cfg7)
    assert coded.CODEWORDS == {4: 2 * 16 * CODEWORDS_SF9, 1: 16 * CODEWORDS_SF7}
