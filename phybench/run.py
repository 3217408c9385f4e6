"""Run one cell of the benchmark once and print one JSON line.

    python3 -m phybench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card. The cell is
looked up in ``BENCHMARK.json``; its configuration, traffic mix and cell
file are read from ``phybench/configs``, ``phybench/traffic`` and
``phybench/workloads`` by name, the program's entry and the ranges its
trace is attributed to from ``phybench/paths/<path>.py`` (the
configuration's ``path``) and each metric's reader, end-to-end or
per-layer, from ``phybench/metrics/<metric>.py``.

A run: set-up (imports, the CUDA context, the program's entry, the pool
of distinct inputs made on the device from the seed, one warm-up call on
every pool item; each phase's seconds logged on standard error),
then a closed loop for ``--seconds``: one caller sends back-to-back calls,
each on the next pool item, each ending with its outputs on the host.
With ``--trace 1`` the first ``trace_calls`` calls of the window run under
``torch.profiler`` and the per-layer metrics are read from that trace;
with ``--trace 0`` the end-to-end metrics are printed. After the window
the outputs of ``check_calls`` calls (drawn from the seed) are compared
with the plain reference (``phybench/reference/<path>.py``) and
``correct`` says whether every compared number is within its limit (the
cell file's ``limits``).

``--control tf32`` puts the reference, computed with TF32 matrix
products, in the program's place: the control whose check must fail.
It is not part of the benchmark's runs.

Exit codes: 0 with a result; 2 without a usable card; 3 when a module of
JAX or of the JAX package is loaded, or the reference imports the
program; no result is printed then.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import ast  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

# every build and kernel cache of the program at a fixed place inside the
# checkout, so that only a checkout's first run builds
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "phybench" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "phybench" / "triton")
# the bytecode of every module imported from here on (torch's thousand and
# more among them) cached there too, whatever the environment says: a
# machine that writes none compiles them all again in every run's set-up
sys.pycache_prefix = str(ROOT / "build" / "phybench" / "pycache")
sys.dont_write_bytecode = False

import numpy as np  # noqa: E402
import torch  # noqa: E402

T_IMPORTS = time.perf_counter()

from .metrics.profile_arith import summarize  # noqa: E402
from .reference.check import combine  # noqa: E402
from .traffic.generator import make_pool  # noqa: E402

# modules that no run may load, by top-level name, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "lora_phy_tpu")
PROGRAM = "lora_phy_tpu_torch"
# the benchmark's own code that must import nothing of the program
INDEPENDENT = ("reference", "traffic")


def load_json(*parts) -> dict:
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def load_file_module(path: pathlib.Path, name: str):
    """Import a file of this package whose name is not an identifier (a
    metric's reader is named after the metric, dots included)."""
    spec = importlib.util.spec_from_file_location(
        f"phybench.metrics.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """Everything one run of one cell reads, found by name."""

    name: str
    bench: dict
    entry: dict
    config: dict
    traffic: dict
    workload: dict

    @classmethod
    def load(cls, name: str, bench: dict | None = None) -> "Cell":
        bench = bench if bench is not None else json.loads((ROOT / "BENCHMARK.json").read_text())
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        workload = load_json("workloads", f"{name}.json")
        if (workload["config"], workload["traffic"]) != (entry["config"], entry["traffic"]):
            raise SystemExit(f"workloads/{name}.json names another config or traffic "
                             f"than BENCHMARK.json")
        return cls(name, bench, entry, load_json("configs", f"{entry['config']}.json"),
                   load_json("traffic", f"{entry['traffic']}.json"), workload)

    def metrics(self, kind: str) -> list[dict]:
        """The cell's end-to-end (``end_to_end``) or per-layer
        (``per_layer``) metrics."""
        return [m for m in self.bench[kind] if self.name in m.get("workloads", [self.name])]


@dataclasses.dataclass
class Window:
    """The measured window of one run, and the set-up before it."""

    calls: int
    seconds: float
    latencies_s: list
    setup_s: float


@dataclasses.dataclass
class MetricContext:
    """What a metric's reader gets: the traced window's summary (per-layer
    metrics; None in an untraced run), the cell's configuration and
    traffic mix, and the measured window (end-to-end metrics)."""

    trace: object
    config: dict
    traffic: dict
    window: Window | None = None


def path_module(cell: Cell):
    return importlib.import_module(f"phybench.paths.{cell.config['path']}")


def program_system(cell: Cell, device):
    return path_module(cell).System(cell.config, device)


def metric_readers(cell: Cell, kind: str) -> list:
    """(entry, reader module) of each of the cell's metrics of ``kind``."""
    return [(m, load_file_module(HERE / "metrics" / f"{m['name']}.py", m["name"]))
            for m in cell.metrics(kind)]


def read_metrics(readers: list, ctx: MetricContext) -> dict:
    """Each metric from its reader; a reader that finds nothing returns
    None and its metric is left out."""
    out = {}
    for m, reader in readers:
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def reference_module(cell: Cell):
    return importlib.import_module(f"phybench.reference.{cell.config['path']}")


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def independent_imports() -> list[str]:
    """Files of the reference and the generator that import the program
    (or JAX): by their source, and by the modules they hold once loaded."""
    bad = set(FORBIDDEN) | {PROGRAM}
    found = []
    for sub in INDEPENDENT:
        for path in sorted((HERE / sub).glob("*.py")):
            for node in ast.walk(ast.parse(path.read_text())):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""] if isinstance(node, ast.ImportFrom)
                         and node.level == 0 else [])
                found += [f"{path.name}: {n}" for n in names if n.split(".")[0] in bad]
    for name, mod in list(sys.modules.items()):
        if name.startswith(tuple(f"phybench.{s}" for s in INDEPENDENT)):
            for v in vars(mod).values():
                top = getattr(v, "__name__", "").split(".")[0] if isinstance(v, type(sys)) else ""
                if top in bad:
                    found.append(f"{name} holds {v.__name__}")
    return found


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values``, linear between
    order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             system=None, control: str | None = None, log=print) -> dict:
    """One run. ``system`` replaces the program's entry (tests); ``control``
    puts the reference, in that precision, in its place. Returns the
    result object (``check`` holds each compared number and its limit)."""
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    stamps = [T0, T_IMPORTS]
    if cuda:
        torch.zeros(1, device=device)        # the CUDA context
    stamps.append(time.perf_counter())
    ref = reference_module(cell)
    if system is None:
        system = (ref.System(cell.config, device, control) if control
                  else program_system(cell, device))
    stamps.append(time.perf_counter())
    pool = make_pool(cell.config, cell.traffic, seed, device)
    sync()
    stamps.append(time.perf_counter())
    for item in pool:                        # every shape and kernel once
        system.readout(system.device(item))
    sync()
    gc.collect()
    gc.freeze()
    stamps.append(time.perf_counter())
    setup_s = stamps[-1] - T0
    log("set-up: " + ", ".join(
        f"{k} {b - a:.3f} s" for k, a, b in zip(("imports", "context", "program", "pool", "warm-up"),
                                               stamps, stamps[1:])))

    rng = np.random.Generator(np.random.PCG64((seed + 1) % 2 ** 63))
    keep, kept_n = cell.workload["check_calls"], 0
    kept = []                                # reservoir of (call, pool index, handle, host)
    trace_calls = cell.workload["trace_calls"] if trace else 0
    latencies, readout_s = [], 0.0
    prof = None
    if trace_calls:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    calls = 0
    t_start = time.perf_counter()
    trace_end = None
    while True:
        i = calls % len(pool)
        t0 = time.perf_counter()
        if calls < trace_calls:
            with record_function("device"):
                handle = system.device(pool[i])
            sync()
            t1 = time.perf_counter()
            with record_function("readout"):
                host = system.readout(handle)
            readout_s += time.perf_counter() - t1
        else:
            handle = system.device(pool[i])
            host = system.readout(handle)
        t_end = time.perf_counter()
        latencies.append(t_end - t0)
        calls += 1
        kept_n += 1
        if len(kept) < keep:
            kept.append((calls - 1, i, handle, host))
        else:
            j = int(rng.integers(0, kept_n))
            if j < keep:
                kept[j] = (calls - 1, i, handle, host)
        if calls == trace_calls:
            sync()
            trace_end = time.perf_counter()
            prof.__exit__(None, None, None)
        del handle, host
        if t_end - t_start >= seconds and calls >= max(trace_calls, 1):
            break
    window_s = t_end - t_start
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    window = Window(calls, window_s, latencies, setup_s)

    result = {"correct": None, "attempted": calls, "failed": 0, "metrics": {}}
    device_desc = ({"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
                   if cuda else {"platform": "cpu", "kind": "cpu", "count": 1})
    device_desc["memory_peak_bytes"] = peak
    if trace:
        # the ranges attributed: the path's, and any a reader names
        readers = metric_readers(cell, "per_layer")
        ranges = tuple(dict.fromkeys((*path_module(cell).RANGES, *(
            r for _, reader in readers for r in getattr(reader, "RANGES", ())))))
        traced_s = trace_end - t_start
        summary = summarize(prof.events(), (*ranges, "readout"),
                            (*ranges, "readout", "device"), trace_calls, traced_s)
        summary.spans["readout"] = readout_s
        result["metrics"] = read_metrics(
            readers, MetricContext(summary, cell.config, cell.traffic, window))
        device_desc["busy_s"] = summary.busy_s
        device_desc["window_s"] = summary.window_s
        top = sorted(summary.kernels.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(summary.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k, v] for k, v in top],
                               "idle_gaps": [[k, v] for k, v in gaps]}
        log(f"trace: {trace_calls} calls, {summary.events / trace_calls:.1f} device events a call, "
            f"busy {summary.busy_s:.6f} s of {summary.window_s:.6f} s; ranges "
            + ", ".join(f"{k} {v[0] / trace_calls * 1e3:.3f} ms / {v[2] / trace_calls:.1f}"
                        for k, v in summary.ranges.items()))
    else:
        result["metrics"] = read_metrics(metric_readers(cell, "end_to_end"),
                                         MetricContext(None, cell.config, cell.traffic, window))
    result["device"] = device_desc
    log(f"window: {calls} calls in {window_s:.3f} s, median {statistics.median(latencies) * 1e3:.3f} ms, "
        f"p95 {percentile(latencies, 95) * 1e3:.3f} ms; set-up {setup_s:.3f} s; peak {peak} B")

    # the check: the kept calls' outputs to the host, the program's state
    # freed, then the reference in blocks
    kept = sorted((call, i, system.outputs(handle, host)) for call, i, handle, host in kept)
    del system
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    refs, parts = {}, []
    for call, i, out in kept:
        if i not in refs:
            refs[i] = ref.reference_outputs(pool[i], cell.config)
        parts.append(ref.judge(pool[i], out, refs[i], cell.config))
        if call == kept[0][0]:
            log(f"truth (call {call}): {ref.truth_summary(pool[i], out)}")
    numbers = combine(parts)
    limits = cell.workload["limits"]
    for k, v in numbers.items():
        if k not in limits:
            log(f"info: {k} {v!r} (not compared)")
    check = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    over = [k for k, c in check.items() if not c["value"] <= c["limit"]]
    result["correct"] = bool(check) and not over
    log(f"check: {len(kept)} calls compared in {time.perf_counter() - t_check:.3f} s")
    result["check"] = check
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    cell = Cell.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        print(f"phybench: the cell needs {cell.entry['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                      control=args.control, log=log)
    loaded, leaks = forbidden_loaded(), independent_imports()
    if loaded or leaks:
        print(f"phybench: loaded {loaded}; the reference or generator imports {leaks}",
              file=sys.stderr)
        return 3
    for k, c in result["check"].items():
        print(f"check: {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
