"""Build and load the CUDA kernels of this package.

The sources in ``csrc/`` have a plain C interface. They are compiled with
``nvcc`` for Hopper (``sm_90a``) into one shared library under
``build/lora_phy_tpu_torch/`` beside the package, at first use and again
whenever a source is newer than the library, and loaded with ``ctypes``.
Nothing is compiled or loaded at import.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import shutil
import subprocess
import tempfile

_PKG = pathlib.Path(__file__).resolve().parent
SOURCES = (_PKG / "csrc" / "fused_demod.cu",)
BUILD_DIR = _PKG.parent / "build" / "lora_phy_tpu_torch"
LIBRARY = BUILD_DIR / "liblora_phy_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


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
    """Compile ``sources`` with nvcc and ``NVCC_FLAGS`` into ``library``.
    Raises ``RuntimeError`` with nvcc's output when it fails."""
    nvcc = find_nvcc()
    library.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent processes never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=library.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, end="")
    os.replace(tmp, library)
    return library


def build(force: bool = False, verbose: bool = False) -> pathlib.Path:
    """Compile ``SOURCES`` into ``LIBRARY`` unless it is newer than every
    source."""
    if (not force and LIBRARY.exists()
            and all(LIBRARY.stat().st_mtime >= s.stat().st_mtime for s in SOURCES)):
        return LIBRARY
    return compile_library(SOURCES, LIBRARY, verbose)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a library built from ``SOURCES``."""
    ptr = ctypes.c_void_p
    lib.lora_fused_demod.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                     ctypes.c_longlong, ctypes.c_int, ptr]
    lib.lora_fused_demod.restype = ctypes.c_int
    lib.lora_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lora_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    return declare(ctypes.CDLL(str(build())))
