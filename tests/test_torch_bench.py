"""The port's benchmark (``lora_phy_tpu_torch/runners/bench.py``), its
block-receiver stage profile (``tools/torch_profile_block_rx.py``) and the
port's console scripts, on the CPU.

Each bench stage's inputs, built by the port at ``bench.py``'s CPU shapes,
are held against the same construction done in JAX from ``bench.py``'s
bodies: payloads and symbols bit-equal, frames bit-equal, the dechirped
planes within 1.3e-7, TX at SF12 within 5e-7 and the wideband synthesis
within 1e-5 (the tolerances ROADMAP states). ``main(["--device=cpu"])``
prints one JSON line with ``bench.py``'s keys (read from ``bench.py`` by
``ast``, without running it).
"""

import ast
import json
import os
import pathlib
import subprocess
import sys
import tomllib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import nn, tparams
from lora_phy_tpu.models import modem as jmodem
from lora_phy_tpu.models import stream as jstream
from lora_phy_tpu.ops import planar as jplanar
from lora_phy_tpu.ops.channelizer import synthesize_channels_planar as jsynth
from lora_phy_tpu.utils.params import LoraParams
from lora_phy_tpu_torch.models import sync as tsync
from lora_phy_tpu_torch.runners import bench as tb

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
DECHIRP_ATOL, TX_TRIG_ATOL, SYNTH_ATOL = 1.3e-7, 5e-7, 1e-5
SHP = tb.shapes(CPU)
P7 = LoraParams(sf=7)


def bench_py_keys() -> set:
    """The keys of ``bench.py``'s one JSON line: the dict literal passed to
    the last ``json.dumps`` in ``main``."""
    tree = ast.parse((REPO / "bench.py").read_text())
    dicts = [node.args[0] for node in ast.walk(tree)
             if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
             and node.args and isinstance(node.args[0], ast.Dict)]
    last = max(dicts, key=lambda d: d.lineno)
    return {k.value for k in last.keys}


def jax_framed(pay, frames, params):
    """bench.py's framed stream (block receiver, wideband) in JAX."""
    fr, fi = jstream.frame_modulate_planar(jmodem.encode(pay), params)
    z = jnp.zeros((pay.shape[0], 4 * params.step), jnp.float32)
    return (jnp.tile(jnp.concatenate([fr, z], -1), (1, frames)),
            jnp.tile(jnp.concatenate([fi, z], -1), (1, frames)))


def test_shapes_are_bench_py_cpu_shrink():
    assert SHP == tb.Shapes(channels=8, frames=64, pool=64, payload_len=32, block_frames=8,
                            sf12_reps=4, channelizer_samples=1 << 16, wideband_frames=4,
                            awgn_packets=256, iters=2)
    gpu = tb.shapes(torch.device("cuda", 0))
    assert (gpu.frames, gpu.block_frames, gpu.sf12_reps, gpu.channelizer_samples,
            gpu.wideband_frames, gpu.awgn_packets, gpu.iters) == (8192, 512, 256, 1 << 25, 512,
                                                                   32768, 8)


def test_payload_draws_follow_bench_py():
    rng = np.random.RandomState(0)
    want = (rng.randint(0, 256, (64, 32)).astype(np.uint8),
            rng.randint(0, 256, (8, 16)).astype(np.uint8),
            rng.randint(0, 256, (8, 16)).astype(np.uint8))
    for got, ref in zip(tb.payload_draws(SHP), want):
        np.testing.assert_array_equal(got, ref)


def test_tx_sync_and_headline_inputs_vs_jax():
    payloads, _, _ = tb.payload_draws(SHP)
    reps = SHP.channels * SHP.frames // SHP.pool
    full = jnp.tile(jnp.asarray(payloads), (reps, 1)).reshape(SHP.channels, SHP.frames, 32)
    jsyms = jmodem.encode(full)
    jre, jim = jplanar.modulate_planar(jsyms, P7)
    re, im = tb.tx_build(torch.from_numpy(payloads), SHP, tparams(P7))
    np.testing.assert_array_equal(nn(re), np.asarray(jre))
    np.testing.assert_array_equal(nn(im), np.asarray(jim))
    # the sync scan's slice of the raw stream
    t = (SHP.frames // 8) * 66 * P7.step
    sr, si = tb.sync_inputs(re, im, SHP, tparams(P7))
    np.testing.assert_array_equal(nn(sr), np.asarray(jre.reshape(SHP.channels, -1)[:, :t]))
    np.testing.assert_array_equal(nn(si), np.asarray(jim.reshape(SHP.channels, -1)[:, :t]))
    xr, xi = tb.headline_inputs(re, im, tparams(P7))
    jxr, jxi = jplanar.dechirp_planar(jre, jim, P7)
    np.testing.assert_allclose(nn(xr), np.asarray(jxr), rtol=0, atol=DECHIRP_ATOL)
    np.testing.assert_allclose(nn(xi), np.asarray(jxi), rtol=0, atol=DECHIRP_ATOL)


def test_block_and_latency_inputs_vs_jax():
    _, pay_blk, _ = tb.payload_draws(SHP)
    br, bi = tb.framed_stream(pay_blk, SHP.block_frames, tparams(P7), CPU)
    jbr, jbi = jax_framed(jnp.asarray(pay_blk), SHP.block_frames, P7)
    np.testing.assert_array_equal(nn(br), np.asarray(jbr))
    np.testing.assert_array_equal(nn(bi), np.asarray(jbi))
    pl1 = tb.payload_draws(SHP)[0][0][:8]
    for sf in tb.LATENCY_SFS:
        p = LoraParams(sf=sf)
        fr, fi = jstream.frame_modulate_planar(jnp.asarray(jmodem.encode(pl1), jnp.int32), p)
        off = 2 * p.step
        t = off + fr.shape[-1] + 6 * p.step
        jr = jnp.zeros(t, jnp.float32).at[off:off + fr.shape[-1]].set(fr)
        ji = jnp.zeros(t, jnp.float32).at[off:off + fr.shape[-1]].set(fi)
        b1r, b1i = tb.latency_inputs(pl1, sf, CPU)
        # SF12's chirps come from the trig path
        atol = TX_TRIG_ATOL if sf >= 11 else 0.0
        np.testing.assert_allclose(nn(b1r), np.asarray(jr), rtol=0, atol=atol)
        np.testing.assert_allclose(nn(b1i), np.asarray(ji), rtol=0, atol=atol)


def test_sf12_inputs_vs_jax():
    pay12 = tb.payload_draws(SHP)[0][:4]
    p12 = LoraParams(sf=12)
    jsyms = jmodem.encode(jnp.tile(jnp.asarray(pay12), (SHP.sf12_reps, 1)))
    jr, ji = jplanar.modulate_planar(jsyms, p12)
    tsyms = tb.modem.encode(torch.from_numpy(pay12).repeat(SHP.sf12_reps, 1))
    np.testing.assert_array_equal(nn(tsyms), np.asarray(jsyms))
    tr, ti = tb.planar.modulate_planar(tsyms, tparams(p12))
    np.testing.assert_allclose(nn(tr), np.asarray(jr), rtol=0, atol=TX_TRIG_ATOL)
    np.testing.assert_allclose(nn(ti), np.asarray(ji), rtol=0, atol=TX_TRIG_ATOL)
    # the stage's input is the port's dechirp of the port's TX; the dechirp
    # of the same TX agrees with JAX's within the dechirp tolerance
    r12, i12 = tb.sf12_inputs(pay12, SHP, CPU)
    dr, di = tb.planar.dechirp_planar(tr, ti, tparams(p12))
    assert torch.equal(r12, dr) and torch.equal(i12, di)
    jdr, jdi = jplanar.dechirp_planar(jnp.asarray(nn(tr)), jnp.asarray(nn(ti)), p12)
    np.testing.assert_allclose(nn(dr), np.asarray(jdr), rtol=0, atol=DECHIRP_ATOL)
    np.testing.assert_allclose(nn(di), np.asarray(jdi), rtol=0, atol=DECHIRP_ATOL)
    assert tuple(r12.shape) == (4 * SHP.sf12_reps, 66 * 4096)


def test_wideband_inputs_vs_jax():
    pay_wb = tb.payload_draws(SHP)[2]
    wr, wi = tb.wideband_inputs(pay_wb, SHP, tparams(P7), CPU)
    jcr, jci = jax_framed(jnp.asarray(pay_wb), SHP.wideband_frames, P7)
    jr, ji = jsynth(jcr, jci, 8, taps_per_branch=15)
    np.testing.assert_allclose(nn(wr), np.asarray(jr), rtol=0, atol=SYNTH_ATOL)
    np.testing.assert_allclose(nn(wi), np.asarray(ji), rtol=0, atol=SYNTH_ATOL)


def test_seeded_inputs_are_reproducible():
    """The channelizer's planes and the AWGN point's draws come from seeded
    torch.Generators (bench.py draws them from JAX's PRNG)."""
    a, b = tb.channelizer_inputs(SHP, CPU), tb.channelizer_inputs(SHP, CPU)
    assert a[0].shape == (SHP.channelizer_samples,) and not torch.equal(a[0], a[1])
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    g1, g2 = tb.awgn_inputs(CPU), tb.awgn_inputs(CPU)
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))


def test_main_prints_bench_py_line(capsys):
    assert tb.main(["--device=cpu"]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == bench_py_keys()
    assert all(v is not None for v in line.values()), line
    assert line["regressed"] is False
    assert line["metric"] == "demod_iq_throughput_sf7"
    assert err.splitlines()[0] == "device: cpu"
    assert "precision: f32, fused: False" in err
    # every stage ran, on the CPU neither kernel launched
    assert set(tb.LAST_RUN) == {"tx", "sync_scan", "headline", "block_rx", "sf12", "channelizer",
                                "wideband_rx", "awgn", "latency_sf7", "latency_sf12"}
    assert tb.LAST_RUN["headline"]["calls"] == 2 + 2 * 3 * SHP.iters
    assert tb.LAST_RUN["sf12"]["calls"] == 1 + 2 * 12
    assert not any(v["fused_demod"] or v["bf16_decide"] or v["decide"]
                   for v in tb.LAST_RUN.values())


@pytest.mark.parametrize("flag", ["--fused", "--precision=bf16"])
def test_headline_and_sf12_stages_take_the_flag(flag):
    """One call per batch: the headline and SF12 stages run the fused or
    bf16 path (their plain versions on the CPU) and pass their gates."""
    small = SHP._replace(channels=1, sf12_reps=1)
    payloads = tb.payload_draws(small)[0]
    re, im = tb.tx_build(torch.from_numpy(payloads), small, tparams(P7))
    xr, xi = tb.headline_inputs(re, im, tparams(P7))
    fused, precision = flag == "--fused", "bf16" if "bf16" in flag else "f32"
    assert tb.time_headline(xr, xi, payloads, tparams(P7), fused, precision,
                            lambda: None, 1) > 0
    assert tb.LAST_RUN["headline"]["calls"] == 2 + 2 * 3
    r12, i12 = tb.sf12_inputs(payloads[:4], small, CPU)
    assert tb.time_sf12(r12, i12, precision, lambda: None) > 0


def test_failing_stage_exits_nonzero_without_a_line():
    code = ("import sys\n"
            "from lora_phy_tpu_torch.runners import bench\n"
            "def boom(*a, **k):\n"
            "    raise RuntimeError('stage broke')\n"
            "bench.time_sync_scan = boom\n"
            "sys.exit(bench.main(['--device=cpu']))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "stage broke" in proc.stderr


def test_fused_with_bf16_is_refused(capsys):
    assert tb.main(["--fused", "--precision=bf16", "--device=cpu"]) == 1
    out, err = capsys.readouterr()
    assert out == "" and len(err.strip().splitlines()) == 1


def test_bad_precision_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        tb.main(["--precision=f16", "--device=cpu"])
    assert e.value.code == 1


def test_regression_gate(tmp_path):
    base = tmp_path / "base.json"
    metrics, lat = {"demod_gsps": 10.0, "block_rx_gsps": 2.0}, {7: (10.0, 0.1, 9.9)}
    card = "card A, 700.00 W"

    def gate(m, la, card=card, precision="f32", fused=False):
        return tb.regression_gate(m, la, card, precision, fused, base)

    assert gate(metrics, lat) is False                                        # no file
    base.write_text(json.dumps({"card": "card A", "power_limit": "700.00 W", "precision": "f32",
                                "fused": False, "demod_gsps": 11.0, "block_rx_gsps": 2.0,
                                "latency_sf7_ms": 9.0}))
    assert gate(metrics, lat) is False
    assert gate({"demod_gsps": 9.0}, {}) is True
    assert gate({}, {7: (10.6, 0.1, 10.5)}) is True
    assert gate({"wideband_rx_gsps": 0.1}, {12: (99.0, 0.1, 98.9)}) is False   # not recorded
    # the floors apply only to the card, power limit and configuration they name
    for other in (dict(card=None), dict(card="card B, 700.00 W"), dict(card="card A, 500.00 W"),
                  dict(precision="bf16"), dict(fused=True)):
        assert gate({"demod_gsps": 1.0}, {7: (99.0, 0.1, 98.9)}, **other) is False, other


def _imports_no_jax(statement: str) -> str:
    return (f"import sys\n{statement}\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'lora_phy_tpu')\n"
            "             or m.startswith(('jax.', 'lora_phy_tpu.')))\n"
            "assert not bad, bad\n")


@pytest.mark.parametrize("statement", [
    "import lora_phy_tpu_torch.runners.bench",
    "import runpy; runpy.run_path('tools/torch_profile_block_rx.py', run_name='not_main')",
])
def test_bench_and_profile_import_no_jax(statement):
    proc = subprocess.run([sys.executable, "-c", _imports_no_jax(statement)], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr


def test_profile_tool_prints_every_stage():
    proc = subprocess.run([sys.executable, "tools/torch_profile_block_rx.py", "--frames=4",
                           "--device=cpu"], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr
    rows = {line.split(":", 1)[1].split()[0] for line in proc.stdout.splitlines()
            if line.startswith("block receiver:")}
    assert set(tsync.CIRCULAR_STAGES) <= rows
    assert "full-receiver" in proc.stdout and "idle share" in proc.stdout


def test_circular_path_runs_in_its_ranges():
    """The block receiver's record_function ranges nest the circular path's
    ops in CIRCULAR_STAGES order, once per call."""
    from torch.profiler import ProfilerActivity, profile

    _, pay_blk, _ = tb.payload_draws(SHP)
    br, bi = tb.framed_stream(pay_blk[:2], 2, tparams(P7), CPU)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tsync.receive_block_planar(br, bi, tparams(P7), 32, max_frames=2, min_power_db=-30.0)
    seen = [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
            if e.name in tsync.CIRCULAR_STAGES]
    assert seen == list(tsync.CIRCULAR_STAGES)


def test_stage_markers_are_ranges_only_while_profiling():
    """Untraced, a stage marker is a no-op context; under a profiler it
    is a record_function range."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile, record_function

    from lora_phy_tpu_torch.utils.profiling import stage_range

    assert isinstance(stage_range("front"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(stage_range("front"), record_function)
    assert isinstance(stage_range("front"), contextlib.nullcontext)


def test_console_scripts_name_every_port_runner():
    """One lora-torch-<name> per runner of the port, plus lora-torch-bench;
    every target is a callable main in a module that imports no JAX; the
    JAX package's lora-* names are unchanged."""
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    torch_scripts = {k: v for k, v in scripts.items() if k.startswith("lora-torch-")}
    runners = sorted(p.stem for p in (REPO / "lora_phy_tpu_torch" / "runners").glob("*.py")
                     if not p.stem.startswith("_"))
    assert sorted(torch_scripts) == sorted(f"lora-torch-{r.replace('_', '-')}" for r in runners)
    for name, target in torch_scripts.items():
        assert target == f"lora_phy_tpu_torch.runners.{name[11:].replace('-', '_')}:main"
    assert all(v.startswith("lora_phy_tpu.runners.") for k, v in scripts.items()
               if not k.startswith("lora-torch-"))
    code = _imports_no_jax(
        "import importlib\n"
        f"for target in {sorted(torch_scripts.values())!r}:\n"
        "    mod, fn = target.split(':')\n"
        "    assert callable(getattr(importlib.import_module(mod), fn)), target")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_phase20c_on_cpu(monkeypatch):
    """chip_smoke.py phase 20 (c) at a small size on the CPU (each kernel's
    plain version on both sides): every N, both configurations, decisions
    equal and at the tones' bins; fused_bound at the SF7 main path's rows
    is phase 4's bound."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "cuda_ms", lambda fn, iters=5, calls=1: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "SMALL_N_SAMPLES", 66 * 64 * 16)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    fused_rows, bf16_rows = cs.phase20c_small_n(CPU, "CPU")
    for rows in (fused_rows, bf16_rows):
        assert sorted(map(int, rows)) == list(cs.SMALL_N)
        for n, r in rows.items():
            assert r["max_abs_err"] == 0 and r["rows"] * int(n) == cs.SMALL_N_SAMPLES
            assert r["launches"] == 0 and r["bound_by"] in ("bytes", "operations")
    assert bf16_rows["4"]["design"] == "mma.sync" and bf16_rows["64"]["design"] == "wgmma"
    _, by, _, nbytes = cs.fused_bound(4325376, 128)
    assert (by, nbytes) == ("bytes", 4 * (2 * 4325376 * 128 + 4 * 4325376 + 2 * 128))
