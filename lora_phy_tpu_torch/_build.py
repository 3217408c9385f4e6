"""Build and load the CUDA kernels of this package.

The sources in ``csrc/`` have a plain C interface. Each is compiled with
``nvcc`` for Hopper (``sm_90a``), all at once in parallel processes, and
the objects are linked into one shared library under
``build/lora_phy_tpu_torch/`` beside the package, at first use and again
whenever a source is newer than the library, and loaded with ``ctypes``.
Nothing is compiled or loaded at import.

Each kernel's wrapper in ``ops/`` holds its C entry point, a name and
its parameter types (:data:`PTR`, :data:`I32`, :data:`I64`, the stream
last), and launches it through :func:`launch`. A new kernel is its
``.cu`` file, its entry in :data:`SOURCES`, its wrapper and its tests;
helpers that several sources share live in a header of ``csrc/``
(:data:`HEADERS`).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

from .utils.profiling import launch_range

_PKG = pathlib.Path(__file__).resolve().parent
SOURCES = (_PKG / "csrc" / "fused_demod.cu", _PKG / "csrc" / "bf16_decide.cu",
           _PKG / "csrc" / "dechirp.cu", _PKG / "csrc" / "windows.cu",
           _PKG / "csrc" / "scan.cu", _PKG / "csrc" / "decide.cu")
# headers the sources include (a change rebuilds the library too)
HEADERS = (_PKG / "csrc" / "fft_rows.cuh", _PKG / "csrc" / "fft_block.cuh")
BUILD_DIR = _PKG.parent / "build" / "lora_phy_tpu_torch"
LIBRARY = BUILD_DIR / "liblora_phy_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# -I: a copy of a source elsewhere (an ablation variant) finds the headers
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-I", str(_PKG / "csrc"))
# ctypes types of the entry points' parameters
PTR, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, then ``PATH``, then ``/usr/local/cuda``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(pathlib.Path(found))
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA toolkit is needed to build the lora_phy_tpu_torch kernels")


def compile_library(sources, library: pathlib.Path, verbose: bool = False) -> pathlib.Path:
    """Compile each of ``sources`` with nvcc and ``NVCC_FLAGS`` (one process
    per source, all started together) and link the objects into
    ``library``. Raises ``RuntimeError`` with nvcc's output when it fails."""
    nvcc = find_nvcc()
    library.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=library.parent) as work:
        jobs = []
        for i, src in enumerate(map(pathlib.Path, sources)):
            obj = pathlib.Path(work) / f"{i}_{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        outputs = [(cmd, obj, proc.communicate()[0], proc.returncode)
                   for cmd, obj, proc in jobs]
        for cmd, _, text, rc in outputs:
            if verbose:
                print(text, end="")
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{text}")
        # link to a private name, then rename: concurrent processes never
        # load a half-written library
        tmp = pathlib.Path(work) / library.name
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _, _ in outputs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, library)
    return library


def build(force: bool = False, verbose: bool = False) -> pathlib.Path:
    """Compile ``SOURCES`` into ``LIBRARY`` unless it is newer than every
    source and header."""
    if (not force and LIBRARY.exists()
            and all(LIBRARY.stat().st_mtime >= s.stat().st_mtime
                    for s in (*SOURCES, *HEADERS))):
        return LIBRARY
    return compile_library(SOURCES, LIBRARY, verbose)


def declare(lib, *entries):
    """Declare ``entries`` on ``lib`` (a library built from ``SOURCES`` or
    from some of them) and return it. An entry is a C entry point's name
    and its parameter types; every entry point returns 0 or a CUDA error
    code."""
    for name, argtypes in entries:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed and load; declares ``lora_cuda_error_string``."""
    lib = ctypes.CDLL(str(build()))
    lib.lora_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lora_cuda_error_string.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def _current_stream(device: torch.device, kernel: str):
    """Enter ``device``'s guard and yield the handle of its current stream;
    off a CUDA device there is no ``kernel``."""
    if device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for device {device}")
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def launch(entry, device: torch.device, range_name: str, *args) -> None:
    """Launch the entry point ``entry`` (name, parameter types) of the
    library with ``args`` and the current stream of ``device``, inside
    ``launch_range(range_name)`` (``"<kernel>.launch"``). Raises
    ``ValueError`` off a CUDA device and ``RuntimeError`` with the CUDA
    error's text when the launch fails; the wrapper counts the launch
    once this returns."""
    kernel = range_name.removesuffix(".launch")
    with _current_stream(device, kernel) as stream:
        lib = declare(load_library(), entry)
        with launch_range(range_name):
            rc = getattr(lib, entry[0])(*args, stream)
    if rc != 0:
        msg = lib.lora_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc} ({msg})")
