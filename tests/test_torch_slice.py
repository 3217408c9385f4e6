"""The port's main path end to end against the JAX package: the bench
chain (bench.py's headline: tiled payload pool -> encode ->
modulate_planar -> dechirp_planar -> demodulate_planar -> decode) at CPU
size, the port's constant tables against JAX's NumPy tables (they stand
in for a weight converter: a PHY has no learned weights), and the port's
freedom from JAX at import."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_util import nn, tt, tparams
from lora_phy_tpu.models import modem as jmodem
from lora_phy_tpu.ops import chirp as jchirp
from lora_phy_tpu.ops import coding as jcoding
from lora_phy_tpu.ops import fft as jfft
from lora_phy_tpu.ops import pallas_demod as jfused
from lora_phy_tpu.ops import planar as jplanar
from lora_phy_tpu.utils.params import LoraParams, Window
import lora_phy_tpu_torch as lt
from lora_phy_tpu_torch.models import modem as tmodem
from lora_phy_tpu_torch.ops import chirp as tchirp
from lora_phy_tpu_torch.ops import coding as tcoding
from lora_phy_tpu_torch.ops import fft as tfft
from lora_phy_tpu_torch.ops import fused_demod as tfused
from lora_phy_tpu_torch.ops import planar as tplanar

REPO = pathlib.Path(__file__).resolve().parents[1]

CHANNELS, FRAMES, PAYLOAD_LEN, POOL = 2, 16, 32, 8


@pytest.fixture(scope="module")
def bench_chain():
    """The bench chain at 2 channels x 16 frames of 32-byte SF7 payloads,
    through JAX and through the port, on the same numpy-seeded pool."""
    p = LoraParams(sf=7)
    tp = tparams(p)
    pool = np.random.RandomState(0).randint(0, 256, (POOL, PAYLOAD_LEN)).astype(np.uint8)
    reps = CHANNELS * FRAMES // POOL
    full = np.tile(pool, (reps, 1)).reshape(CHANNELS, FRAMES, PAYLOAD_LEN)

    j = {"syms": jmodem.encode(full)}
    j["tx"] = jplanar.modulate_planar(j["syms"], p)
    j["dech"] = jplanar.dechirp_planar(*j["tx"], p)
    j["demod"] = jplanar.demodulate_planar(*j["dech"], p)
    j["demod_fused"] = jplanar.demodulate_planar(*j["dech"], p, fused=True)

    t = {"syms": tmodem.encode(torch.from_numpy(pool).repeat(reps, 1)
                               .reshape(CHANNELS, FRAMES, PAYLOAD_LEN))}
    t["tx"] = tplanar.modulate_planar(t["syms"], tp)
    t["dech"] = tplanar.dechirp_planar(*t["tx"], tp)
    t["demod"] = tplanar.demodulate_planar(*t["dech"], tp)
    t["demod_fused"] = tplanar.demodulate_planar(*t["dech"], tp, fused=True)
    return p, full, j, t


def test_bench_chain_tx_bit_equal(bench_chain):
    p, full, j, t = bench_chain
    np.testing.assert_array_equal(nn(t["syms"]), nn(j["syms"]).astype(np.int32))
    for mine, ref in zip(t["tx"], j["tx"]):
        assert tuple(mine.shape) == (CHANNELS, FRAMES, (2 * PAYLOAD_LEN + 2) * p.step)
        np.testing.assert_array_equal(nn(mine), nn(ref))
    for mine, ref in zip(t["dech"], j["dech"]):     # one float32 ulp (FMA)
        np.testing.assert_allclose(nn(mine), nn(ref), rtol=0, atol=1.3e-7)


@pytest.mark.parametrize("key", ["demod", "demod_fused"])
def test_bench_chain_decodes_bit_exact(bench_chain, key):
    p, full, j, t = bench_chain
    got, ref = t[key], j[key]
    np.testing.assert_array_equal(nn(got.symbols), nn(ref.symbols).astype(np.int32))
    np.testing.assert_array_equal(nn(got.sync_word),
                                  np.full((CHANNELS, FRAMES), 0x12, np.uint8))
    np.testing.assert_array_equal(nn(tmodem.decode(got.symbols)), full)
    np.testing.assert_allclose(nn(got.cfo), nn(ref.cfo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(nn(got.time_offset), nn(ref.time_offset),
                               rtol=0, atol=2e-3)


_HANN7 = LoraParams(sf=7, window=Window.HANN)
_HANN12 = LoraParams(sf=12, window=Window.HANN)
_TABLES = {
    "hamming84_enc": (lambda: tcoding._H84_ENC, lambda: jcoding._H84_ENC),
    "hamming84_dec": (tcoding._h84_dec, lambda: (jcoding._H84_DEC_NIB,
                                                  jcoding._H84_DEC_ERR,
                                                  jcoding._H84_DEC_BAD)),
    "crc": (lambda: (tcoding._CRC_STEP, tcoding._CRC_V, tcoding._CRC_DIST),
            lambda: (jcoding._CRC_STEP, jcoding._CRC_V, jcoding._CRC_DIST)),
    "tx_table_sf7": (lambda: tchirp._mod_chirp_tables(128, 1, 8, False)[1:],
                     lambda: jchirp._mod_chirp_tables(128, 1, 8, False)[1:]),
    "tx_table_sf7_osr2_cont": (lambda: tchirp._mod_chirp_tables(128, 2, 8, True)[1:],
                               lambda: jchirp._mod_chirp_tables(128, 2, 8, True)[1:]),
    "downchirp_sf7": (lambda: tchirp.base_downchirp_planar(7, 1.0, 1),
                      lambda: jchirp.base_downchirp_planar(7, 1.0, 1)),
    "fft_dft_mats_4096": (lambda: tfft._dft_mats(4096)[:3],
                          lambda: jfft._dft_mats(4096)[:3]),
    "small_dft_128": (lambda: tplanar._small_dft_tables(128),
                      lambda: jplanar._small_dft_tables(128)),
    "combined_dft_128": (lambda: (tplanar._combined_dft_mat(128),),
                         lambda: (jplanar._combined_dft_mat(128),)),
    "combined_fourstep_1024": (lambda: tplanar._combined_fourstep_mats(1024),
                               lambda: jplanar._combined_fourstep_mats(1024)),
    "fused_dft_hann_128": (
        lambda: tfused._dft_tables(128, tuple(tmodem._window_table(tparams(_HANN7)))),
        lambda: jfused._dft_tables(128, tuple(jmodem._window_table(_HANN7)))),
    "hann_window": (lambda: (tmodem._window_table(tparams(_HANN7)),
                             tmodem._window_table(tparams(_HANN12))),
                    lambda: (jmodem._window_table(_HANN7), jmodem._window_table(_HANN12))),
}


@pytest.mark.parametrize("name", sorted(_TABLES))
def test_constant_tables_bit_equal(name):
    mine, ref = (f() for f in _TABLES[name])
    mine = mine if isinstance(mine, tuple) else (mine,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


def test_device_table_uploads_the_numpy_table():
    wr, wi = lt.device_table(tplanar._small_dft_tables, 64, device="cpu")
    assert isinstance(wr, torch.Tensor) and wr.dtype == torch.float32
    np.testing.assert_array_equal(nn(wr), jplanar._small_dft_tables(64)[0])
    assert lt.device_table(tplanar._small_dft_tables, 64, device="cpu")[0] is wr


def test_device_of_never_guesses(monkeypatch):
    """An explicit device or the input tensor's device wins; otherwise the
    first CUDA card, and without one a clear error — never the CPU."""
    x = torch.zeros(2)
    assert lt.device_of(x) == torch.device("cpu")
    assert lt.device_of(None, device="cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lt.device_of(np.zeros(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lt.device_of(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert lt.device_of(np.zeros(2)) == torch.device("cuda", 0)


def test_tf32_off_at_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_import_without_jax():
    """Importing the port and every module of it loads neither JAX nor
    any module of the JAX package."""
    code = ("import importlib, pkgutil, sys\n"
            "import lora_phy_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'lora_phy_tpu_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "assert 'lora_phy_tpu_torch.models.sync' in names, names\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'lora_phy_tpu')\n"
            "             or m.startswith(('jax.', 'lora_phy_tpu.')))\n"
            "assert not bad, bad\n"
            "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 12


def _imported_modules(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(
    [*(REPO / "lora_phy_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py",
     REPO / "tools" / "torch_kernel_ablation.py", REPO / "tools" / "torch_profile_block_rx.py"]),
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_names_the_jax_package(path):
    """No import statement of the port, of chip_smoke.py or of the port's
    kernel ablation and block-receiver profile scripts names jax or the JAX
    package, even one that would not load JAX."""
    bad = sorted(m for m in _imported_modules(path)
                 if m.split(".")[0] in ("jax", "lora_phy_tpu"))
    assert not bad, bad
