"""The port's structure, read from its source: imports point one way,
``runners -> parallel -> models -> ops -> utils``, with ``ops/planar.py``
above the ops it dispatches to; and the five hand kernels launch through
the one path of ``_build.launch``.

The import checks parse the package's files (no module is imported), so
an import inside a function counts as much as one at the top.
"""

import ast
import contextlib
import ctypes
import pathlib
import types

import pytest
import torch

from lora_phy_tpu_torch import LoraParams, _build
from lora_phy_tpu_torch.ops import bf16_decide, dechirp, fused_demod, scan, windows

PKG = "lora_phy_tpu_torch"
ROOT = pathlib.Path(__file__).resolve().parents[1] / PKG
LAYERS = ("utils", "ops", "models", "parallel", "runners")
KERNEL_OPS = ("fft", "dechirp", "windows", "fused_demod", "bf16_decide", "scan")
# the one arrow that still points up: utils.profiling.demod_roofline reads
# the four-step's factorisation (ops.fft._split) inside the function
UPWARD = {("utils/profiling.py", f"{PKG}.ops.fft"), ("utils/profiling.py", f"{PKG}.ops.fft._split")}


def module_name(path: pathlib.Path) -> str:
    parts = path.relative_to(ROOT.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def imported(path: pathlib.Path) -> set[str]:
    """Every module an import of ``path`` may load, anywhere in the file:
    ``from a import b`` names both ``a`` and ``a.b`` (``b`` may be a
    submodule)."""
    package = module_name(path)
    if path.name != "__init__.py":
        package = package.rpartition(".")[0]
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                up = package.split(".")[: len(package.split(".")) - node.level + 1]
                base = ".".join(up + ([base] if base else []))
            names.add(base)
            names.update(f"{base}.{a.name}" for a in node.names)
    return names


def reaches(path: pathlib.Path, target: str) -> list[str]:
    return sorted(n for n in imported(path) if n == target or n.startswith(target + "."))


@pytest.mark.parametrize("layer", LAYERS[:-1])
def test_no_layer_imports_a_layer_above_it(layer):
    above = [f"{PKG}.{name}" for name in LAYERS[LAYERS.index(layer) + 1:]]
    found = {(str(p.relative_to(ROOT)), h) for p in sorted((ROOT / layer).rglob("*.py"))
             for t in above for h in reaches(p, t)}
    assert not found - UPWARD, sorted(found - UPWARD)


def test_sync_imports_nothing_of_stream():
    assert not reaches(ROOT / "models" / "sync.py", f"{PKG}.models.stream")


@pytest.mark.parametrize("name", KERNEL_OPS)
def test_kernel_ops_sit_below_planar(name):
    assert not reaches(ROOT / "ops" / f"{name}.py", f"{PKG}.ops.planar")


def meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


# one call of each wrapper that reaches its launch: meta tensors pass the
# operand checks, and their data pointers are 0
WRAPPER_CALLS = {
    "dechirp": (dechirp, lambda: dechirp.dechirp(meta(2, 256), meta(2, 256),
                                                 meta(128), meta(128))),
    "windows": (windows, lambda: windows.shifted_windows_kernel(
        meta(2, 128), meta(2, 128), 4, 32, 1, meta(2, dtype=torch.int32))),
    "fused_demod": (fused_demod, lambda: fused_demod.fused_detect_rows(
        meta(4, 32), meta(4, 32), meta(4), meta(4), LoraParams(sf=5))),
    "bf16_decide": (bf16_decide, lambda: bf16_decide.bf16_decide_rows(
        meta(4, 32), meta(4, 32), 32)),
    "scan": (scan, lambda: scan.scan_peaks(meta(2, 512), meta(2, 512), meta(128), meta(128),
                                           128, 1, 0)),
}


@pytest.mark.parametrize("kernel", sorted(WRAPPER_CALLS))
def test_failed_launch_raises_and_is_not_counted(kernel, monkeypatch):
    """A fake library whose entry point returns CUDA error 700: the
    wrapper raises RuntimeError naming the kernel and the error's text,
    after one call that passed every parameter of the entry's signature
    (the stream last), and its LAUNCHES does not move."""
    module, call = WRAPPER_CALLS[kernel]
    name, argtypes = module.ENTRY
    calls = []

    def entry(*args):
        calls.append(args)
        return 700

    fake = types.SimpleNamespace(**{name: entry}, lora_cuda_error_string=lambda rc: {
        700: b"an illegal memory access was encountered"}[rc])
    monkeypatch.setattr(_build, "load_library", lambda: fake)
    monkeypatch.setattr(_build, "_current_stream",
                        lambda device, kernel: contextlib.nullcontext(12345))
    launches = module.LAUNCHES
    with pytest.raises(RuntimeError, match=rf"^{kernel} kernel launch failed: CUDA error 700 "
                                           r"\(an illegal memory access was encountered\)$"):
        call()
    assert module.LAUNCHES == launches
    assert len(calls) == 1 and len(calls[0]) == len(argtypes) and calls[0][-1] == 12345
    assert entry.argtypes == argtypes and entry.restype is ctypes.c_int


@pytest.mark.parametrize("kernel", sorted(WRAPPER_CALLS))
def test_launch_off_cuda_names_the_kernel(kernel):
    """Off a CUDA device the one launch path raises before it loads the
    library (no build is tried)."""
    _, call = WRAPPER_CALLS[kernel]
    with pytest.raises(ValueError, match=rf"^no {kernel} kernel for device meta$"):
        call()
