#!/usr/bin/env python3
"""What the compiler and the card make of the port's two CUDA kernels, one
instantiation at a time, and two trees' kernels timed in turns.

    python3 tools/torch_kernel_resources.py [--csrc DIR] [--compare OTHER]

For the kernel sources in ``DIR`` (default: ``lora_phy_tpu_torch/csrc``;
give another tree's ``csrc`` to look at an earlier version, e.g. one
unpacked with ``git archive`` into ``committed_tree/``):

1. ``ptxas -v`` of each source (nvcc with the package's flags): registers,
   stack frame, spill stores and loads, static shared memory of every
   kernel instantiation, demangled;
2. ``cuobjdump -sass``: the local-memory loads and stores (``LDL`` /
   ``STL``) in each instantiation's machine code;
3. one launch of every instantiation through the library's C entry points
   (``lora_fused_demod`` at N = 4..128 with and without a window,
   ``lora_bf16_decide`` at N = 4..4096 with and without rotation) over
   2^26 / N rows under ``torch.profiler``: the grid and block the launcher
   chose, registers per thread and shared memory as the card reports
   them, and blocks per SM (the launchers size a persistent grid to the
   blocks the card holds at once, so grid / SMs);
4. with ``--compare OTHER`` (another tree's ``csrc``): every instantiation
   built from OTHER and from DIR, timed in turns on one card (OTHER, DIR,
   DIR, OTHER, twice; CUDA events over 10 launches, median of 5 each;
   the medians of the four of each side): ``fused_demod`` on
   ``chip_smoke.py`` phase 20 (c)'s tone rows (553,648,128 samples a
   call) without a window and with the Hann window, ``bf16_decide`` on
   random rows of the main paths' sizes (553,648,128 samples a call at
   N <= 128, 276,824,064 above, SF8-12's paths), 66 rows a rotation row.

Every result is one JSON line on stdout, with the card's name and power
limit (``nvidia-smi``); the build goes to
``build/lora_phy_tpu_torch/resources/``. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from lora_phy_tpu_torch import LoraParams, Window, _build, device_table  # noqa: E402
from lora_phy_tpu_torch.ops import bf16_decide as bf16  # noqa: E402
from lora_phy_tpu_torch.ops import fused_demod as fused  # noqa: E402
from lora_phy_tpu_torch.utils.params import _window_table  # noqa: E402

OUT_DIR = _build.BUILD_DIR / "resources"
FUSED_N = (4, 8, 16, 32, 64, 128)

def emit(record):
    print(json.dumps(record), flush=True)


def demangle(names):
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return dict(zip(names, out))


def short(name):
    """``void <unnamed>::fused_demod_small<(int)8, (bool)0>(...)`` ->
    ``fused_demod_small<8, 0>``: the kernel and its template arguments."""
    name = re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::|\((int|bool)\)", "", name)
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            return name[:i]
    return name


def parse_ptxas(text):
    """{mangled kernel: {registers, smem, stack, spill_stores,
    spill_loads}} from ``ptxas -v`` output (entry functions only)."""
    found, current = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Function properties for|Compiling entry function) '?([^'\s]+)", line)
        if m:
            current = m.group(1)
            found.setdefault(current, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and current:
            found[current].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                  spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            s = re.search(r"(\d+) bytes smem", line)
            found[current].update(registers=int(m.group(1)), smem=int(s.group(1)) if s else 0)
    return {k: v for k, v in found.items() if "registers" in v}


def parse_sass(text):
    """{mangled kernel: {instructions, LDL, STL, CALL}} from
    ``cuobjdump -sass`` output."""
    counts, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1)
            counts[current] = dict(instructions=0, LDL=0, STL=0, CALL=0)
        elif current and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            c = counts[current]
            c["instructions"] += 1
            for op in ("LDL", "STL", "CALL"):
                c[op] += bool(re.search(rf"\b{op}\b", line))
    return counts


def ptxas_resources(src: pathlib.Path, work: pathlib.Path):
    """Compile ``src`` to an object with ``-Xptxas -v``; returns the object
    and {kernel: parse_ptxas's fields}, demangled."""
    obj = work / f"{src.stem}.o"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
           str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
    kernels = parse_ptxas(proc.stdout + proc.stderr)
    names = demangle(list(kernels))
    return obj, {short(names[k]): v for k, v in kernels.items()}


def sass_counts(obj: pathlib.Path):
    """{kernel: parse_sass's fields} of the object's SASS, demangled."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = parse_sass(subprocess.run([tool, "-sass", str(obj)], capture_output=True,
                                       text=True, check=True).stdout)
    names = demangle(list(counts))
    return {short(names[k]): v for k, v in counts.items()}


def build_library(sources, out: pathlib.Path) -> ctypes.CDLL:
    return _build.declare(ctypes.CDLL(str(_build.compile_library(sources, out))),
                          fused.ENTRY, bf16.ENTRY)


def launch_all(lib, dev):
    """One launch of every instantiation over 2^26 / N rows; returns the
    kernel events of one profiler window."""
    from torch.profiler import ProfilerActivity, profile

    stream = torch.cuda.current_stream(dev).cuda_stream
    calls = []
    for n in FUSED_N:
        rows = (1 << 26) // n
        x = torch.zeros(rows, n, device=dev)
        z = torch.zeros(rows, device=dev)
        out = torch.empty(rows, dtype=torch.int32, device=dev)
        tw = device_table(fused._twiddles, n, device=dev)
        win = torch.ones(n, device=dev)
        for window in (None, win):
            calls.append((f"fused_demod N={n} window={window is not None}",
                          lambda x=x, z=z, out=out, tw=tw, window=window, rows=rows, n=n:
                          lib.lora_fused_demod(x.data_ptr(), x.data_ptr(), z.data_ptr(),
                                               z.data_ptr(), z.data_ptr(),
                                               None if window is None else window.data_ptr(),
                                               tw.data_ptr(), out.data_ptr(), rows, n,
                                               stream)))
    for n in bf16.KERNEL_N:
        rows = (1 << 26) // n
        x = torch.zeros(rows, n, device=dev)
        c = torch.ones(rows, n, device=dev)
        out = torch.empty(rows, dtype=torch.int32, device=dev)
        tables = [None if t is None else t.data_ptr() for t in bf16._kernel_tables(n, dev)]
        for rot in (False, True):
            calls.append((f"bf16_decide N={n} rotated={rot}",
                          lambda x=x, c=c, out=out, tables=tables, rot=rot, rows=rows, n=n:
                          lib.lora_bf16_decide(x.data_ptr(), x.data_ptr(),
                                               c.data_ptr() if rot else None,
                                               c.data_ptr() if rot else None, rows, 1, n,
                                               *tables, out.data_ptr(), None, stream)))
    for label, call in calls:          # built and warm
        rc = call()
        chip_smoke.check(rc == 0, f"{label}: launch failed ({rc})")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _, call in calls:
            call()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    kernels = [e for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    chip_smoke.check(len(kernels) == len(calls),
                     f"{len(kernels)} kernel events for {len(calls)} launches")
    return [(label, e) for (label, _), e in zip(calls, kernels)]


def compare(card, libs, dev):
    """Each instantiation of the two libraries ({"other": lib, "this":
    lib}) in turns on the same rows."""
    gen = torch.Generator(device=dev).manual_seed(14)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    stream = torch.cuda.current_stream(dev).cuda_stream

    def turns(record, launch):
        times = {"other": [], "this": []}
        for side in ("other", "this", "this", "other") * 2:
            times[side].append(chip_smoke.cuda_ms(lambda: launch(libs[side]), iters=5, calls=10))
        med = {k: statistics.median(v) for k, v in times.items()}
        emit({"card": card, **record, "other_ms": times["other"], "this_ms": times["this"],
              "other_median_ms": med["other"], "this_median_ms": med["this"],
              "this_over_other": med["this"] / med["other"]})

    for n in FUSED_N:
        xr, xi, start, rate, scale, _ = chip_smoke.small_n_fused_rows(gen, n, dev)
        rows = xr.shape[0]
        window = device_table(_window_table,
                              LoraParams(sf=n.bit_length() - 1, window=Window.HANN), device=dev)
        tw = device_table(fused._twiddles, n, device=dev)
        out = torch.empty(rows, dtype=torch.int32, device=dev)
        for win in (None, window):
            def launch(lib, win=win):
                rc = lib.lora_fused_demod(xr.data_ptr(), xi.data_ptr(), start.data_ptr(),
                                          rate.data_ptr(), scale.data_ptr(),
                                          None if win is None else win.data_ptr(),
                                          tw.data_ptr(), out.data_ptr(), rows, n, stream)
                chip_smoke.check(rc == 0, f"fused_demod N={n}: launch failed ({rc})")
            turns({"compare": "fused_demod", "n": n, "rows": rows, "window": win is not None},
                  launch)
        del xr, xi, start, rate, scale, out
        torch.cuda.empty_cache()
    for n in bf16.KERNEL_N:
        samples = chip_smoke.SMALL_N_SAMPLES // (1 if n <= 128 else 2)
        rows, rpr = samples // n, chip_smoke.SMALL_N_WINDOWS
        yr, yi = rand(rows, n) - 0.5, rand(rows, n) - 0.5
        cr, si = rand(rows // rpr, n) - 0.5, rand(rows // rpr, n) - 0.5
        tables = [None if t is None else t.data_ptr() for t in bf16._kernel_tables(n, dev)]
        out = torch.empty(rows, dtype=torch.int32, device=dev)
        for rot in (True, False):
            def launch(lib, rot=rot):
                rc = lib.lora_bf16_decide(yr.data_ptr(), yi.data_ptr(),
                                          cr.data_ptr() if rot else None,
                                          si.data_ptr() if rot else None, rows, rpr, n,
                                          *tables, out.data_ptr(), None, stream)
                chip_smoke.check(rc == 0, f"bf16_decide N={n}: launch failed ({rc})")
            turns({"compare": "bf16_decide", "n": n, "rows": rows, "rotated": rot}, launch)
        del yr, yi, cr, si, out
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=pathlib.Path, default=_build.SOURCES[0].parent)
    ap.add_argument("--compare", type=pathlib.Path, metavar="OTHER")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_resources.py needs a CUDA device")
    card = chip_smoke.card_line()
    csrc = args.csrc.resolve()
    sources = [csrc / s.name for s in _build.SOURCES]
    tag = "current" if csrc == _build.SOURCES[0].parent else csrc.parent.parent.name
    work = OUT_DIR / tag
    work.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(sources) + 2) as pool:
        lib_job = pool.submit(build_library, sources, work / "libkernels.so")
        other_job = None
        if args.compare:
            other_dir = OUT_DIR / "compare_other"
            other_dir.mkdir(parents=True, exist_ok=True)
            other_job = pool.submit(build_library,
                                    [args.compare.resolve() / s.name for s in _build.SOURCES],
                                    other_dir / "libkernels.so")
        res = list(pool.map(lambda s: ptxas_resources(s, work), sources))
        lib = lib_job.result()
        other = other_job.result() if other_job else None
    for obj, kernels in res:
        sass = sass_counts(obj)
        for name, r in sorted(kernels.items()):
            emit({"card": card, "csrc": str(csrc), "kernel": name, **r, **sass.get(name, {})})
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, e in launch_all(lib, dev):
        a = e.get("args", {})
        grid = a.get("grid", [0, 1, 1])
        blocks = grid[0] * grid[1] * grid[2]
        emit({"card": card, "launch": label, "kernel": short(e["name"]), "grid": grid,
              "block": a.get("block"), "registers_per_thread": a.get("registers per thread"),
              "shared_memory": a.get("shared memory"), "blocks_per_sm": blocks / sms,
              "est_occupancy_pct": a.get("est. achieved occupancy %"), "us": e.get("dur")})
    torch.cuda.empty_cache()
    if other is not None:
        torch.cuda.empty_cache()
        compare(card, {"other": other, "this": lib}, dev)


if __name__ == "__main__":
    main()
