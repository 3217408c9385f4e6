"""Port parity of the sweep tools: ``tools/torch_soft_waterfall_sweep.py``
and ``tools/torch_sync_sensitivity_sweep.py`` against
``tools/soft_waterfall_sweep.py`` and ``tools/sync_sensitivity_sweep.py``
on the CPU, on JAX's own noise draws.

The twins draw from a ``torch.Generator`` where the JAX tools draw from a
``PRNGKey``; both take injected unit normal planes in its place. Fed the
JAX tool's two ``jax.random.normal`` draws (split from the same key), the
twins' noisy planes are JAX's (the sync sweep's within 2 float32 ulps:
XLA fuses the jitted draws into their multiply-add) and every count is
JAX's: the waterfall's hard and soft frame losses at two cells, and the sync
sweep's whole CSV (synced, hard, soft / ML counts and their intervals at
every SF and SNR) at two trials a cell.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lora_phy_tpu.models import coded as jcoded

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _load(rel):
    spec = importlib.util.spec_from_file_location(pathlib.Path(rel).stem, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return {rel: _load(f"tools/{rel}.py") for rel in (
        "soft_waterfall_sweep", "torch_soft_waterfall_sweep",
        "sync_sensitivity_sweep", "torch_sync_sensitivity_sweep")}


def _jax_draws(key, shape):
    """The JAX tools' two unit normal planes of ``key`` (as
    ``ops/impair.apply_awgn`` and ``_noisy_chunk`` split and draw them)."""
    kr, ki = jax.random.split(key)
    return (np.array(jax.random.normal(kr, shape, jnp.float32)),
            np.array(jax.random.normal(ki, shape, jnp.float32)))


def _sync_noise(sf, snr, ci, b, t):
    return _jax_draws(jax.random.PRNGKey(sf * 1000003 + (snr + 64) * 911 + ci), (b, t))


@pytest.mark.parametrize("cr,snr", [(1, -10.0), (4, -12.0)])
def test_waterfall_losses_equal_jax_on_its_draws(tools, cr, snr):
    n_frames = 8
    jh, js = tools["soft_waterfall_sweep"].losses(cr, snr, n_frames)
    cfg = jcoded.CodedConfig(sf=7, cr=cr)
    n_sym = jcoded.payload_symbol_count(12, cfg)
    draws = _jax_draws(jax.random.PRNGKey(0), (n_frames, (n_sym + 2) * 128))
    tw = tools["torch_soft_waterfall_sweep"]
    assert tw.losses(cr, snr, n_frames, device=CPU, noise=draws) == (jh, js)
    # the twin's own draws: counts of the same frames
    h, s = tw.losses(cr, snr, n_frames, device=CPU)
    assert 0 <= s <= n_frames and 0 <= h <= n_frames


def test_waterfall_main_writes_the_jax_header(tools, tmp_path):
    """The CSV's header and cells are the JAX tool's (its counts come from
    other draws)."""
    flags = ["--frames=8", "--crs=4", "--snrs=-12"]    # the shapes of a cell above
    jout, tout = tmp_path / "jax.csv", tmp_path / "torch.csv"
    assert tools["soft_waterfall_sweep"].main(flags + [f"--out={jout}"]) == 0
    tw = tools["torch_soft_waterfall_sweep"]
    assert tw.main(flags + ["--device=cpu", f"--out={tout}"]) == 0
    jrows, trows = jout.read_text().splitlines(), tout.read_text().splitlines()
    assert trows[0] == jrows[0] and len(trows) == len(jrows) == 2
    assert trows[1].split(",")[:3] == jrows[1].split(",")[:3] == ["4", "-12.0", "8"]
    assert tw.main(["--frame=2"]) == 1
    # the default curve lies beside the JAX tool's, never over it
    assert tw.DEFAULT_OUT == "logs/soft_vs_hard_waterfall_r4_torch.csv"


def test_noisy_chunk_equals_jax_on_its_draws(tools):
    js, ts = tools["sync_sensitivity_sweep"], tools["torch_sync_sensitivity_sweep"]
    rng = np.random.RandomState(5)
    base_r, base_i = (rng.randn(3000).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(7)
    jr, ji = js._noisy_chunk_j(key, jnp.asarray(base_r), jnp.asarray(base_i), -9.0, 3)
    draws = _jax_draws(key, (3, 3000))
    tr, ti = ts.noisy_chunk(torch.from_numpy(base_r), torch.from_numpy(base_i), -9.0,
                            *draws)
    # the jitted JAX program fuses the draws' inverse erf with the
    # multiply-add (FMA contraction), so its planes differ from the same
    # draws taken outside it by at most 2 float32 ulps of the larger of the
    # sum and the noise term
    sig = np.float32(10.0 ** (9.0 / 20.0) / np.sqrt(2.0))
    for got, want, n in ((tr, jr, draws[0]), (ti, ji, draws[1])):
        want = np.asarray(want)
        scale = np.maximum(np.abs(want), np.abs(n * sig))
        assert (np.abs(got.numpy() - want) <= 2 * np.spacing(scale)).all()


@pytest.mark.parametrize("flags", [["--trials=2", "--chunk=2"],
                                   ["--soft", "--trials=2", "--chunk=2"]],
                         ids=["hamming84", "soft"])
def test_sync_sweep_csv_equals_jax_on_its_draws(tools, tmp_path, flags):
    jout, tout = tmp_path / "jax.csv", tmp_path / "torch.csv"
    assert tools["sync_sensitivity_sweep"].main(flags + [f"--out={jout}"]) == 0
    ts = tools["torch_sync_sensitivity_sweep"]
    assert ts.main(flags + ["--device=cpu", f"--out={tout}"], noise=_sync_noise) == 0
    jrows, trows = jout.read_text().splitlines(), tout.read_text().splitlines()
    assert len(jrows) == 19
    assert trows == jrows
    # the knee is inside the cut: some cell syncs part of its trials or
    # decodes fewer than it syncs
    cells = [[int(x) for x in r.split(",")[2:5]] for r in jrows[1:]]
    assert any(0 < s < n or h < s for n, s, h in cells)


def test_sync_sweep_flags_and_default_draws(tools, tmp_path):
    ts = tools["torch_sync_sensitivity_sweep"]
    assert ts.main(["--trial=3"]) == 1
    assert ts.DEFAULT_OUT == "logs/sync_sensitivity_r5_torch.csv"
    # one cell on the twin's own draws, pre_acc=3 (--robust's receiver)
    synced, hard, ml = ts.cell(7, -6, 2, chunk=2, pre_acc=3, device=CPU)
    assert 0 <= ml <= synced <= 2 and 0 <= hard <= synced
