"""Port parity of the golden-vector tools and the perf tools:
lora_phy_tpu_torch's ``utils/{manifest,vectors,profiling}.py``,
``runners/{vector_generate,vector_dump,compare_vectors,
comprehensive_vector_generate,compare_perf,perf_test,roofline}.py`` and
``ops/chirp.gen_chirp``, against the JAX twins on the CPU
(``tests/test_runners.py``'s cases, ``tests/test_vectors.py``'s record
checks and ``tests/test_parallel.py``'s roofline case).

Vector files are compared by SHA256. Every decision file (payload,
pre/post interleave, demod symbols, deinterleave, decoded) is hash-equal
to JAX's on every cell. The IQ CSVs print each float32 at ``%g`` (six
significant digits), so one ulp can flip the last printed digit:
``iq_samples.csv`` is hash-equal where the port's TX reads its chirp
tables (SF7, SF9 here) and within the trig-path TX tolerance 5e-7 plus
one printed digit (1e-6) at SF12; ``iq_samples_offset.csv`` (CFO and
shift injectors, XLA's and torch's cos/sin) within the injector tolerance
1e-6 plus one printed digit.
"""

import base64
import json
import pathlib

import numpy as np
import pytest
import torch

from _torch_util import nn, run_cli, tparams
from lora_phy_tpu.ops import chirp as jchirp
from lora_phy_tpu.runners import compare_perf as jcp
from lora_phy_tpu.runners import comprehensive_vector_generate as jcv
from lora_phy_tpu.runners import vector_dump as jvd
from lora_phy_tpu.runners import vector_generate as jvg
from lora_phy_tpu.utils import profiling as jprof
from lora_phy_tpu.utils import vectors as jvec
from lora_phy_tpu.utils.params import Bandwidth, LoraParams, Window
from lora_phy_tpu_torch.ops import chirp as tchirp
from lora_phy_tpu_torch.runners import compare_perf as tcp
from lora_phy_tpu_torch.runners import compare_vectors as tcmp
from lora_phy_tpu_torch.runners import comprehensive_vector_generate as tcv
from lora_phy_tpu_torch.runners import perf_test as tpt
from lora_phy_tpu_torch.runners import roofline as trl
from lora_phy_tpu_torch.runners import vector_dump as tvd
from lora_phy_tpu_torch.runners import vector_generate as tvg
from lora_phy_tpu_torch.utils import profiling as tprof
from lora_phy_tpu_torch.utils import vectors as tvec
from lora_phy_tpu_torch.utils.manifest import compare_dirs, sha256_file

CPU = ["--device=cpu"]
DECISION_FILES = ("payload.bin", "pre_interleave.csv", "post_interleave.csv",
                  "demod_symbols.csv", "deinterleave.csv", "decoded.bin")
# one printed digit of a |value| < 1 at %g, and the float tolerances of the
# two IQ files (ROADMAP Queue 3: trig-path TX, injectors)
PRINTED_DIGIT = 1e-6
TX_TRIG_TOL = 5e-7
INJECTOR_TOL = 1e-6

# (sf, osr, window, cfo_bins, time_offset): SF7/9/12, osr 1/2, Hann, with
# and without the injectors
GRID = [
    (7, 1, Window.NONE, 0.0, 0.0),
    (7, 2, Window.HANN, 0.25, 2.0),
    (9, 1, Window.HANN, 0.0, 0.0),
    (9, 2, Window.NONE, 0.25, -3.0),
    (12, 1, Window.NONE, 0.5, 0.0),
    (12, 2, Window.HANN, 0.0, 2.0),
]


def _iq(path) -> np.ndarray:
    return np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)


def _b64(path) -> bytes:
    return base64.b64decode(pathlib.Path(path).read_bytes())


# ---------------------------------------------------------------------------
# vector_generate / vector_dump / compare_vectors (test_runners.py:49-101)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sf,osr,window,cfo,shift", GRID,
                         ids=[f"sf{c[0]}-osr{c[1]}-{c[2].name.lower()}-cfo{c[3]}-to{c[4]}"
                              for c in GRID])
def test_generate_matches_jax(tmp_path, sf, osr, window, cfo, shift):
    p = LoraParams(sf=sf, osr=osr, window=window)
    kw = dict(seed=5, byte_count=16, cfo_bins=cfo, time_offset=shift, b64=False)
    j = jvg.generate(tmp_path / "jax", p, **kw)
    t = tvg.generate(tmp_path / "port", tparams(p), device="cpu", **kw)
    names = sorted(f.name for f in j.iterdir())
    assert names == sorted(f.name for f in t.iterdir())
    assert ("iq_samples_offset.csv" in names) == bool(cfo or shift)
    for name in DECISION_FILES:
        assert sha256_file(t / name) == sha256_file(j / name), name
    # the IQ files: by hash where the port's TX reads its tables, else
    # by their parsed values
    if sf < 12:
        assert sha256_file(t / "iq_samples.csv") == sha256_file(j / "iq_samples.csv")
    else:
        a, b = _iq(t / "iq_samples.csv"), _iq(j / "iq_samples.csv")
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= TX_TRIG_TOL + PRINTED_DIGIT
    if cfo or shift:
        a, b = _iq(t / "iq_samples_offset.csv"), _iq(j / "iq_samples_offset.csv")
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= INJECTOR_TOL + TX_TRIG_TOL + PRINTED_DIGIT
    if not cfo and not shift and sf < 12:
        assert compare_dirs(j, t) == []


def test_vector_generate_manifest(tmp_path):
    p = tparams(LoraParams(sf=7))
    out = tvg.generate(tmp_path / "v1", p, seed=1, byte_count=16, device="cpu")
    names = sorted(f.name for f in out.iterdir())
    assert "manifest.json" in names
    assert "payload.bin.b64" in names and "decoded.bin.b64" in names
    manifest = json.loads((out / "manifest.json").read_text())
    assert set(manifest["files"]) == set(n for n in names if n != "manifest.json")
    # the working-path divergence: decoded == payload (unlike the reference)
    assert _b64(out / "payload.bin.b64") == _b64(out / "decoded.bin.b64")
    # the base64 files and the manifest are JAX's, byte for byte
    j = jvg.generate(tmp_path / "j1", LoraParams(sf=7), seed=1, byte_count=16)
    assert compare_dirs(j, out) == []
    assert (j / "manifest.json").read_bytes() == (out / "manifest.json").read_bytes()


def test_vector_quirk_compat_differs(tmp_path):
    """--quirk-compat reproduces the reference's broken integrated goldens:
    decoded.bin != payload.bin in both packages. The demod files are held
    to that gate, not to JAX's hashes: on a flat spectrum JAX's default
    ``xla`` FFT backend reads cfo 0.601 where the port (and JAX's ``dft``
    backend) read 0.674 (ROADMAP Queue 3), so the quirk decisions differ.
    The files before the demod are hash-equal."""
    p = LoraParams(sf=7)
    j = jvg.generate(tmp_path / "jq", p, seed=1, byte_count=16, quirk_compat=True)
    t = tvg.generate(tmp_path / "tq", tparams(p), seed=1, byte_count=16,
                     quirk_compat=True, device="cpu")
    for d in (j, t):
        assert _b64(d / "payload.bin.b64") != _b64(d / "decoded.bin.b64")
    for name in ("payload.bin.b64", "pre_interleave.csv.b64",
                 "post_interleave.csv.b64", "iq_samples.csv.b64"):
        assert sha256_file(t / name) == sha256_file(j / name), name


def test_vector_determinism_and_compare(tmp_path, capfd):
    p = tparams(LoraParams(sf=7))
    a = tvg.generate(tmp_path / "a", p, seed=3, byte_count=8, device="cpu")
    b = tvg.generate(tmp_path / "b", p, seed=3, byte_count=8, device="cpu")
    assert run_cli(tcmp.main, [str(a), str(b)], capfd)[0] == 0
    c = tvg.generate(tmp_path / "c", p, seed=4, byte_count=8, device="cpu")
    rc, _, err = run_cli(tcmp.main, [str(a), str(c)], capfd)
    assert rc == 1 and "FAIL" in err and "hash mismatch" in err
    assert run_cli(tcmp.main, [str(a)], capfd)[0] == 2


def test_vector_impairments(tmp_path):
    p = tparams(LoraParams(sf=7))
    out = tvg.generate(tmp_path / "imp", p, seed=1, byte_count=8,
                       cfo_bins=0.25, time_offset=2.0, b64=False, device="cpu")
    assert (out / "iq_samples_offset.csv").exists()
    a, b = _iq(out / "iq_samples_offset.csv"), _iq(out / "iq_samples.csv")
    assert a.shape == b.shape and not np.array_equal(a, b)


def test_vector_dump_stage_selection(tmp_path, monkeypatch, capfd):
    monkeypatch.chdir(tmp_path)
    args = ["--sf=7", "--bytes=16", "--dump=payload,decoded,iq"]
    assert run_cli(jvd.main, args + ["--out=jdump"], capfd)[0] == 0
    assert run_cli(tvd.main, args + ["--out=dump"] + CPU, capfd)[0] == 0
    names = sorted(f.name for f in pathlib.Path("dump").iterdir())
    assert names == ["decoded.bin", "iq_samples.csv", "manifest.json", "payload.bin"]
    assert compare_dirs("jdump", "dump") == []
    rc, _, err = run_cli(tvd.main, ["--dump=payload,bogus"] + CPU, capfd)
    assert rc == 1 and "bogus" in err


def test_vector_runners_main(tmp_path, monkeypatch, capfd):
    """vector_generate's CLI writes under vectors/lora_phy/<--out> as JAX's
    does, with the same files."""
    monkeypatch.chdir(tmp_path)
    args = ["--sf=9", "--window=hann", "--cfo-bins=0.5", "--seed=2"]
    assert run_cli(jvg.main, args + ["--out=j"], capfd)[0] == 0
    rc, _, err = run_cli(tvg.main, args + ["--out=t"] + CPU, capfd)
    assert rc == 0 and "vectors written to" in err
    j, t = pathlib.Path("vectors/lora_phy/j"), pathlib.Path("vectors/lora_phy/t")
    assert sorted(f.name for f in j.iterdir()) == sorted(f.name for f in t.iterdir())
    for name in DECISION_FILES + ("iq_samples.csv",):
        assert sha256_file(t / f"{name}.b64") == sha256_file(j / f"{name}.b64"), name
    assert run_cli(tvg.main, CPU, capfd)[0] == 1                   # no --out


# ---------------------------------------------------------------------------
# comprehensive_vector_generate and the record format (test_runners.py:128,
# test_vectors.py)
# ---------------------------------------------------------------------------

def test_comprehensive_vector_generate(tmp_path, capfd):
    from lora_phy_tpu_torch.models import modem
    from lora_phy_tpu_torch.ops import coding

    out = tmp_path / "cv"
    assert run_cli(tcv.main, [f"--out={out}"] + CPU, capfd)[0] == 0
    ham = tvec.load_binary_vectors(out / "hamming_tests.bin")
    assert len(ham) == 16 * 9  # 16 nibbles x (clean + 8 single-bit flips)
    for rec in ham:
        nib, err, _ = coding.hamming84_decode(torch.tensor(list(rec.extra), dtype=torch.uint8))
        assert int(nib[0]) == rec.payload[0]
        assert (rec.test_type == "single_error") == bool(err[0])
    mod = tvec.load_binary_vectors(out / "modulation_tests.bin")
    assert len(mod) == 30
    for rec in mod[:5]:
        syms = torch.from_numpy(np.frombuffer(rec.extra, "<u2").astype(np.int32))
        assert nn(modem.decode(syms)).tobytes() == rec.payload
    # both files hash-equal to the JAX twin's
    assert run_cli(jcv.main, [f"--out={tmp_path / 'jcv'}"], capfd)[0] == 0
    assert compare_dirs(tmp_path / "jcv", out) == []


def _records(seed=0):
    rng = np.random.RandomState(seed)
    recs = []
    for k in range(7):
        recs.append(tvec.VectorRecord(
            ["no_error", "single_error", "modulation", ""][k % 4],
            rng.randint(0, 256, k * 3).astype(np.uint8).tobytes(), 5 + k,
            f"4/{5 + k % 4}", rng.randint(0, 256, k * 5).astype(np.uint8).tobytes()))
    return recs


def test_binary_vectors_round_trip_bytes_equal_jax(tmp_path):
    recs = _records()
    tvec.write_binary_vectors(tmp_path / "t.bin", recs)
    jvec.write_binary_vectors(tmp_path / "j.bin", [
        jvec.VectorRecord(*(getattr(r, f) for f in
                            ("test_type", "payload", "spread_factor", "coding_rate", "extra")))
        for r in recs])
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    assert tvec.load_binary_vectors(tmp_path / "t.bin") == recs
    assert [vars(r) for r in jvec.load_binary_vectors(tmp_path / "t.bin")] == \
        [vars(r) for r in recs]
    # a truncated file raises, as the JAX reader does
    data = (tmp_path / "t.bin").read_bytes()
    (tmp_path / "cut.bin").write_bytes(data[:-3])
    with pytest.raises(ValueError, match="truncated"):
        tvec.load_binary_vectors(tmp_path / "cut.bin")
    with pytest.raises(ValueError, match="truncated"):
        jvec.load_binary_vectors(tmp_path / "cut.bin")


@pytest.fixture(scope="module")
def corpus(reference_dir):
    d = reference_dir / "vectors_binary"
    if not d.exists():
        pytest.skip("vectors_binary corpus unavailable")
    return d


def test_corpus_records_equal_jax(corpus):
    """Every corpus file parses to JAX's records, with test_vectors.py's
    documented counts."""
    from test_vectors import EXPECTED_COUNTS

    for name, count in EXPECTED_COUNTS.items():
        got = tvec.load_binary_vectors(corpus / name)
        ref = jvec.load_binary_vectors(corpus / name)
        assert len(got) == count
        assert [vars(r) for r in got] == [vars(r) for r in ref]


def test_corpus_modulation_records_over_the_air(corpus):
    """test_vectors.py's sample of modulation records through the port's
    encode -> modulate -> dechirp -> demodulate -> decode."""
    from lora_phy_tpu_torch.models import modem

    recs = [r for r in tvec.load_binary_vectors(corpus / "modulation_tests.bin")
            if r.payload and 7 <= r.spread_factor <= 12][:12]
    for rec in recs:
        p = tparams(LoraParams(sf=rec.spread_factor))
        payload = torch.tensor(list(rec.payload), dtype=torch.uint8)
        res = modem.demodulate(modem.dechirp(modem.modulate(modem.encode(payload), p), p), p)
        assert nn(modem.decode(res.symbols)).tobytes() == rec.payload


# ---------------------------------------------------------------------------
# compare_perf / perf_test (test_runners.py:104, :151)
# ---------------------------------------------------------------------------

HDR = "run_id,profile,sf,N,pps,us_per_symbol\n"
PERF_CASES = {
    "ok": (HDR + "r1,sf7,7,128,1000,5.0\n", HDR + "r2,sf7,7,128,1200,4.0\n"),
    "bad": (HDR + "r1,sf7,7,128,1000,5.0\n", HDR + "r2,sf7,7,128,800,7.0\n"),
    "missing": (HDR + "r1,sf7,7,128,1000,5.0\nr1,sf9,9,512,100,9.0\n",
                HDR + "r2,sf7,7,128,1000,5.0\n"),
    "cycles": ("run_id,profile,sf,N,pps,cycles_per_symbol\nr1,sf7,7,128,1000,50\n",
               "run_id,profile,sf,N,pps,cycles_per_symbol\nr2,sf7,7,128,990,52\n"),
}


@pytest.mark.parametrize("case", sorted(PERF_CASES))
@pytest.mark.parametrize("tol", [0.0, 0.05])
def test_compare_perf_equals_jax(tmp_path, capfd, case, tol):
    base, new = tmp_path / "base.csv", tmp_path / "new.csv"
    base.write_text(PERF_CASES[case][0])
    new.write_text(PERF_CASES[case][1])
    assert tcp.compare(base, new, tol) == jcp.compare(base, new, tol)
    args = [str(base), str(new)] + ([str(tol)] if tol else [])
    assert run_cli(tcp.main, args, capfd)[:3] == run_cli(jcp.main, args, capfd)[:3]


def test_compare_perf_gate(tmp_path, capfd):
    base, ok, bad = (tmp_path / n for n in ("base.csv", "ok.csv", "bad.csv"))
    base.write_text(PERF_CASES["ok"][0])
    ok.write_text(PERF_CASES["ok"][1])
    bad.write_text(PERF_CASES["bad"][1])
    assert run_cli(tcp.main, [str(base), str(ok)], capfd)[0] == 0
    assert run_cli(tcp.main, [str(base), str(bad)], capfd)[0] == 1
    assert run_cli(tcp.main, [str(base)], capfd)[0] == 2


def test_perf_harness_smoke(tmp_path, monkeypatch, capfd):
    """perf_test produces a compare_perf-compatible CSV (tiny CPU run)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("RUN_ID", "smoke")
    rc, _, err = run_cli(tpt.main, ["--packets=8", "--payload-bytes=8"] + CPU, capfd)
    assert rc == 0, err
    lines = (tmp_path / "logs" / "performance_smoke.csv").read_text().strip().splitlines()
    assert lines[0] == "run_id,profile,sf,N,pps,us_per_symbol"
    assert len(lines) == 4  # 3 default profiles
    for row in lines[1:]:
        assert float(row.split(",")[4]) > 0 and float(row.split(",")[5]) > 0
    assert [r.split(",")[1:4] for r in lines[1:]] == [
        ["sf7_bw125_cr45", "7", "128"], ["sf7_bw125_cr47", "7", "128"],
        ["sf8_bw125_cr45", "8", "256"]]
    path = tmp_path / "logs" / "performance_smoke.csv"
    assert run_cli(tcp.main, [str(path), str(path)], capfd)[0] == 0


@pytest.mark.parametrize("sf,bw", [(9, Bandwidth.BW_250), (12, Bandwidth.BW_500)])
def test_perf_run_profile_scaled_bins(sf, bw):
    """The perf matrix's BW250 / BW500 profiles: the sanity check holds the
    bins to the scaled expectation (no decode: the scale is not 1)."""
    pps, usps = tpt.run_profile(tparams(LoraParams(sf=sf, bw=bw)), 8, payload_len=2,
                                device="cpu")
    assert pps > 0 and usps > 0


# ---------------------------------------------------------------------------
# profiling / roofline (test_parallel.py:652)
# ---------------------------------------------------------------------------

def test_profiling_roofline():
    r7 = tprof.demod_roofline(tparams(LoraParams(sf=7)), 1000)
    assert r7.flops > 0 and r7.bytes > 0
    assert r7.bound in ("compute", "memory")
    assert 0 < r7.attained(max(r7.t_compute_s, r7.t_memory_s) * 2) <= 0.5
    r12 = tprof.demod_roofline(tparams(LoraParams(sf=12)), 1000)
    assert r12.flops < 1000 * 8 * 4096 * 4096  # four-step, not dense N^2
    # the H100 peaks are the defaults, and no TPU peak is defined
    assert (tprof.H100_F32_FLOPS, tprof.H100_HBM_BPS) == (67e12, 3.35e12)
    assert r7.t_memory_s == r7.bytes / 3.35e12
    assert not [n for n in vars(tprof) if n.startswith("V5")]


@pytest.mark.parametrize("sf", range(7, 13))
def test_demod_roofline_equals_jax(sf):
    peaks = dict(peak_flops=tprof.H100_F32_FLOPS, peak_bw=tprof.H100_HBM_BPS)
    for n_sym in (1, 4096):
        t = tprof.demod_roofline(tparams(LoraParams(sf=sf)), n_sym, **peaks)
        j = jprof.demod_roofline(LoraParams(sf=sf), n_sym, **peaks)
        assert vars(t) == vars(j)
        assert t.attained(1e-3) == j.attained(1e-3)


def test_trace_writes_a_chrome_trace(tmp_path):
    from lora_phy_tpu_torch.ops import planar

    p = tparams(LoraParams(sf=7))
    xr, xi = planar.dechirp_planar(*planar.modulate_planar(
        torch.arange(8, dtype=torch.int32)[None], p), p)
    with tprof.trace(tmp_path / "tr") as d:
        planar.demodulate_planar(xr, xi, p)
    doc = json.loads((d / "trace.json").read_text())
    names = {e.get("name", "") for e in doc["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


def test_roofline_measures_on_cpu(monkeypatch, capfd):
    """The three measurements at small sizes, and main's three kinds of
    line with a small bandwidth stream and frame count (never its 5 GiB
    defaults here)."""
    cpu = torch.device("cpu")
    assert 0 < trl.measure_dispatch_overhead(cpu) < 1.0
    assert trl.measure_bandwidth(cpu, sizes=(1 << 12, 1 << 16)) > 0
    dt, total = trl.measure_demod(tparams(LoraParams(sf=7)), 4, 2, device=cpu)
    assert dt > 0 and total == 2 * 4 * 66 * 128
    bandwidth, demod = trl.measure_bandwidth, trl.measure_demod
    monkeypatch.setattr(trl, "measure_bandwidth",
                        lambda dev: bandwidth(dev, sizes=(1 << 12, 1 << 16)))
    # main's SF12 row takes at least 64 frames; two do here
    monkeypatch.setattr(trl, "measure_demod",
                        lambda p, frames, ch, device: demod(p, min(frames, 2), ch, device=device))
    rc, out, err = run_cli(trl.main, ["--channels=1", "--frames=8"] + CPU, capfd)
    assert rc == 0, err
    assert "the floors below are the H100's, not this device's" in err
    lines = out.strip().splitlines()
    assert lines[0].startswith("dispatch overhead: ")
    assert lines[1].startswith("effective bandwidth (r+w, overhead-cancelled): ")
    assert [l.split(":")[0] for l in lines[2:]] == ["SF7", "SF12"]
    assert all("compute floor" in l and "intrinsic-traffic floor" in l for l in lines[2:])


# ---------------------------------------------------------------------------
# gen_chirp, and the runners' --device flag
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,osr,nn_,f0,down,bw", [
    (128, 1, 128, 0.0, True, 1.0), (128, 2, 300, 17.5, False, 1.0),
    (512, 1, 512, -3.25, False, 2.0), (4096, 4, 1000, 100.0, True, 4.0)])
def test_gen_chirp_vs_jax(n, osr, nn_, f0, down, bw):
    s, end = tchirp.gen_chirp(n, osr, nn_, f0, down, 0.7, 0.3, bw, device="cpu")
    js, jend = jchirp.gen_chirp(n, osr, nn_, f0, down, 0.7, 0.3, bw)
    assert s.dtype == torch.complex64 and s.device.type == "cpu"
    np.testing.assert_array_equal(nn(s), np.asarray(js))
    assert end == jend


def test_gen_chirp_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tchirp.gen_chirp(128, 1, 128, 0.0, True)


@pytest.mark.parametrize("name,args", [
    ("vector_generate", ["--out=x"]), ("vector_dump", []),
    ("comprehensive_vector_generate", []), ("perf_test", []), ("roofline", []),
    ("sic_sweep", []), ("scope", ["--in=x.iq"])])
def test_runners_need_a_card_or_device_cpu(name, args, monkeypatch, tmp_path, capfd):
    import importlib

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"lora_phy_tpu_torch.runners.{name}").main
    rc, out, err = run_cli(main, args, capfd)
    assert rc == 1 and "no CUDA device" in err and not out
    assert list(tmp_path.iterdir()) == []
