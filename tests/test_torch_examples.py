"""Port parity of the examples: ``examples/torch_end_to_end.py`` and
``examples/torch_mesh_gateway.py`` against ``examples/end_to_end.py`` and
``examples/mesh_gateway.py``, in-process on the suite's eight virtual CPU
devices (JAX) and on CPU shards (the port).

The printed lines are equal, section for section, with one exception the
twins cannot share: the repr of a mesh's shape (JAX's ``Mesh.shape`` is
an ``OrderedDict``, the port's a ``dict``), compared by its items. The
coded chain's noise comes from ``PRNGKey(0)`` in JAX and from a
``torch.Generator`` seeded 0 in the port: its line (bytes, crc_ok,
fec_corrections) is equal all the same. The gateway's checkpoint goes to
one fixed temporary directory in both runs, so its line is equal too. The
twin reads the gr-lora_sdr capture only where ``--capture`` names it, so
its section is given the file that the JAX example reads.
"""

import importlib.util
import os
import pathlib
import re
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch
from conftest import REFERENCE_DIR

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SECTIONS = ["simple_chain", "coded_chain", "streaming", "sharded", "wideband",
            "gr_capture"]


def _load(rel):
    spec = importlib.util.spec_from_file_location(pathlib.Path(rel).stem, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def examples():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return {rel: _load(rel) for rel in (
        "examples/end_to_end.py", "examples/torch_end_to_end.py",
        "examples/mesh_gateway.py", "examples/torch_mesh_gateway.py")}


def _mesh_shape_items(line):
    """A line with the mesh shape's repr replaced by its items."""
    return re.sub(r"(?:OrderedDict\()?(\{[^}]*\})\)?", r"\1", line)


@pytest.mark.parametrize("section", SECTIONS)
def test_end_to_end_section_prints_jax_lines(examples, capsys, section):
    getattr(examples["examples/end_to_end.py"], section)()
    jlines = capsys.readouterr().out.splitlines()
    twin = examples["examples/torch_end_to_end.py"]
    if section == "gr_capture":
        twin.gr_capture(CPU, REFERENCE_DIR / "vectors_binary" / twin.CAPTURE_NAME)
    else:
        getattr(twin, section)(CPU)
    tlines = capsys.readouterr().out.splitlines()
    assert len(jlines) >= 2
    if section == "sharded":
        assert jlines[-1].startswith("mesh OrderedDict(")
        assert tlines[-1].endswith("decoded ok=True")
        jlines, tlines = ([_mesh_shape_items(x) for x in lines] for lines in (jlines, tlines))
    assert tlines == jlines


def test_end_to_end_reads_no_capture_beside_its_checkout(capsys, tmp_path):
    """Without ``--capture`` the twin reads no file, not even one at the
    reference checkout's layout beside the directory it lies in."""
    examples_dir = tmp_path / "checkout" / "examples"
    examples_dir.mkdir(parents=True)
    rel = "examples/torch_end_to_end.py"
    (examples_dir / pathlib.Path(rel).name).write_text((REPO / rel).read_text())
    twin = _load(examples_dir / pathlib.Path(rel).name)
    beside = tmp_path / "reference" / "vectors_binary" / twin.CAPTURE_NAME
    beside.parent.mkdir(parents=True)
    np.zeros(4096, np.float32).tofile(beside)
    twin.gr_capture(CPU)
    assert capsys.readouterr().out.splitlines()[-1] == "(capture not available)"
    twin.gr_capture(CPU, tmp_path / "absent.cf32")
    assert capsys.readouterr().out.splitlines()[-1] == "(capture not available)"


def test_mesh_gateway_prints_jax_lines(examples, capsys, monkeypatch, tmp_path):
    ckpt_dir = tmp_path / "ckpt"
    ckpt_dir.mkdir()
    monkeypatch.setattr(tempfile, "mkdtemp", lambda: str(ckpt_dir))
    examples["examples/mesh_gateway.py"].main()
    jlines = capsys.readouterr().out.splitlines()
    assert examples["examples/torch_mesh_gateway.py"].main(["--device=cpu"]) == 0
    tlines = capsys.readouterr().out.splitlines()
    assert len(jlines) == 12 and jlines[-1].startswith("all 10 frames recovered exactly once")
    assert tlines == jlines


@pytest.mark.parametrize("rel", ["examples/torch_end_to_end.py",
                                 "examples/torch_mesh_gateway.py"])
def test_example_needs_a_card_or_cpu(examples, monkeypatch, rel):
    """Without --device the example goes to the first CUDA card, and
    without one it raises; an unknown flag exits."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        examples[rel].main([])
    with pytest.raises(SystemExit):
        examples[rel].main(["--devices=cpu"])


@pytest.mark.parametrize("rel,last", [
    ("examples/torch_end_to_end.py", "(capture not available)"),
    ("examples/torch_mesh_gateway.py", "all 10 frames recovered exactly once (2 time "
                                        "shards, 2 channels, checkpoint/restart mid-stream)")])
def test_example_runs_as_a_script(rel, last):
    """``python <example> --device=cpu`` from any directory: rc 0 and the
    example's last line."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(REPO / rel), "--device=cpu"],
                          cwd=tempfile.gettempdir(), env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == last
