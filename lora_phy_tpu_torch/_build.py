"""Build and load the CUDA kernels of this package.

The sources in ``csrc/`` have a plain C interface. Each is compiled with
``nvcc`` for Hopper (``sm_90a``), all at once in parallel processes, and
the objects are linked into one shared library under
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
SOURCES = (_PKG / "csrc" / "fused_demod.cu", _PKG / "csrc" / "bf16_decide.cu",
           _PKG / "csrc" / "dechirp.cu", _PKG / "csrc" / "windows.cu")
BUILD_DIR = _PKG.parent / "build" / "lora_phy_tpu_torch"
LIBRARY = BUILD_DIR / "liblora_phy_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")


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
    source."""
    if (not force and LIBRARY.exists()
            and all(LIBRARY.stat().st_mtime >= s.stat().st_mtime for s in SOURCES)):
        return LIBRARY
    return compile_library(SOURCES, LIBRARY, verbose)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a library built from ``SOURCES`` (or
    from a subset of them: an entry point the library lacks is skipped)."""
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    signatures = {
        "lora_fused_demod": ([ptr] * 8 + [i64, i32, ptr], i32),
        "lora_bf16_decide": ([ptr] * 4 + [i64, i64, i32] + [ptr] * 9, i32),
        "lora_dechirp": ([ptr, i64, i64] * 2 + [ptr] * 4 + [i64] * 3 + [ptr], i32),
        "lora_windows": ([ptr, i64, i64] * 2 + [ptr] * 3 + [i64] * 5 + [ptr], i32),
        "lora_cuda_error_string": ([i32], ctypes.c_char_p),
    }
    for name, (argtypes, restype) in signatures.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    return declare(ctypes.CDLL(str(build())))
