"""Port parity of the graft entry: ``torch_graft_entry`` (the PyTorch
port's twin of ``__graft_entry__.py``) against the JAX entry on the CPU.

* ``entry()``'s forward on the JAX entry's inputs gives its symbols and
  sync words bit-equal; the port's own inputs (TX + dechirp in torch) lie
  within the dechirp tolerance of JAX's (1.3e-7, ROADMAP Queue 3) and
  decode to the same decisions.
* ``dryrun_multichip(8)`` on eight CPU shards prints the JAX dryrun's
  lines letter for letter (its asserts hold inside), and the port's
  dryrun holds at the other mesh layouts the entry builds.
* Without a card the entry points raise unless given the CPU.
* Every repo-level twin file imports neither jax nor the JAX package (a
  subprocess import, so the test's own JAX imports do not count).
"""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
import torch_graft_entry as tentry
from _torch_util import nn, tt

REPO = pathlib.Path(__file__).resolve().parents[1]
DECHIRP_ATOL = 1.3e-7

# the repo-level twins of files that drive the JAX package
TWIN_FILES = ["torch_graft_entry.py", "examples/torch_end_to_end.py",
              "examples/torch_mesh_gateway.py", "tools/torch_soft_waterfall_sweep.py",
              "tools/torch_sync_sensitivity_sweep.py"]


def test_entry_forward_equals_jax():
    jfwd, (jxr, jxi) = jentry.entry()
    jsyms, jsync = jfwd(jxr, jxi)
    tfwd, (txr, txi) = tentry.entry(device="cpu")
    assert txr.device.type == "cpu" and tuple(txr.shape) == tuple(jxr.shape)
    # the port's forward on JAX's inputs: bit-equal decisions
    syms, sync = tfwd(tt(jxr), tt(jxi))
    np.testing.assert_array_equal(nn(syms), nn(jsyms))
    np.testing.assert_array_equal(nn(sync), nn(jsync))
    # the port's own chain: the same planes within the dechirp tolerance,
    # the same decisions
    np.testing.assert_allclose(nn(txr), nn(jxr), rtol=0, atol=DECHIRP_ATOL)
    np.testing.assert_allclose(nn(txi), nn(jxi), rtol=0, atol=DECHIRP_ATOL)
    syms, sync = tfwd(txr, txi)
    np.testing.assert_array_equal(nn(syms), nn(jsyms))
    assert bool((sync == 0x12).all())


def test_dryrun_multichip_prints_jax_lines(capsys):
    """JAX's dryrun on the suite's eight virtual devices against the port's
    on eight CPU shards: the same lines (each path's asserts pass inside)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    jentry.dryrun_multichip(8)
    jlines = capsys.readouterr().out.splitlines()
    tentry.dryrun_multichip(8, device="cpu")
    tlines = capsys.readouterr().out.splitlines()
    assert len(jlines) == 8
    assert tlines == jlines


@pytest.mark.parametrize("n_devices,layout", [(1, "1x1"), (2, "1x2"), (4, "2x2")])
def test_dryrun_multichip_other_layouts(capsys, n_devices, layout):
    """The port's dryrun at smaller meshes (no seam at one time shard):
    every path's asserts hold. (At three or more channels on one time
    shard the adaptive frames' fixed offsets overrun the block, in the JAX
    dryrun as here.)"""
    tentry.dryrun_multichip(n_devices, device="cpu")
    last = capsys.readouterr().out.splitlines()[-1]
    assert last.startswith(f"dryrun_multichip OK: mesh={layout} ({n_devices} devices)")


@pytest.mark.parametrize("call", [lambda: tentry.entry(),
                                  lambda: tentry.dryrun_multichip(8)],
                         ids=["entry", "dryrun_multichip"])
def test_entry_points_default_to_the_card(monkeypatch, call):
    """Without a card and without device="cpu" they raise; with a card
    visible they go to cuda:0 (here a CPU-only torch, which refuses it)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises((RuntimeError, AssertionError), match="CUDA|cuda"):
        call()


@pytest.mark.parametrize("rel", TWIN_FILES)
def test_twin_file_imports_no_jax(rel):
    """Importing the file (not running its main) loads neither jax nor any
    module of the JAX package."""
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('twin', {str(REPO / rel)!r})\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'lora_phy_tpu')\n"
            "             or m.startswith(('jax.', 'lora_phy_tpu.')))\n"
            "assert not bad, bad\n"
            "assert 'lora_phy_tpu_torch' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
