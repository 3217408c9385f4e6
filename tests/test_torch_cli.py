"""Port parity of the command line: lora_phy_tpu_torch.runners ``tx_runner``
/ ``rx_runner`` (``tests/test_runners.py``'s round trips and error paths),
``gr_decode`` and ``awgn_sweep``, checkpoints resumed across the two
packages (single-device and adaptive), the runners' ``--device`` flag, and
a subprocess that runs the port's runners as ``python -m`` without
importing JAX or the JAX package.

IQ files are byte-equal to the JAX runners'; printed decisions are equal;
``rx_runner --report-offsets`` prints cfo and time_offset to six decimals,
compared within 2e-6 and 2e-3 (the port's offsets agree with JAX's within
1e-6 bins and 2e-3 samples, ROADMAP Queue 3)."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_util import assert_same_lines, run_cli
from lora_phy_tpu.runners import rx_runner as jrr
from lora_phy_tpu.runners import rx_stream as jrx
from lora_phy_tpu.runners import tx_runner as jtr
from lora_phy_tpu.utils.params import LoraParams
from lora_phy_tpu_torch.runners import rx_runner as trr
from lora_phy_tpu_torch.runners import rx_stream as trx
from lora_phy_tpu_torch.runners import tx_runner as ttr
from lora_phy_tpu_torch.runners import tx_stream as ttx
from lora_phy_tpu_torch.utils.iqio import read_iq, write_iq
from test_rx_stream import _interleave, _make_stream

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = ["--device=cpu"]


def _offsets(err: str) -> dict:
    line = [l for l in err.splitlines() if l.startswith("crc_ok=")][0]
    return dict(kv.split("=") for kv in line.split())


def both_runners(tx_args, rx_args, tmp_path, capfd):
    """tx_runner then rx_runner of each package; asserts byte-equal IQ
    files and equal printed payloads and offsets; returns the port's
    (rc, out, err) of rx_runner."""
    jp, tp = tmp_path / "jax.iq", tmp_path / "port.iq"
    assert run_cli(jtr.main, tx_args + [f"--out={jp}"], capfd)[0] == 0
    assert run_cli(ttr.main, tx_args + [f"--out={tp}"] + CPU, capfd)[0] == 0
    assert tp.read_bytes() == jp.read_bytes()
    j = run_cli(jrr.main, rx_args + [f"--in={jp}"], capfd)
    t = run_cli(trr.main, rx_args + [f"--in={tp}"] + CPU, capfd)
    assert t[0] == j[0] and t[1] == j[1]
    if "--report-offsets" in rx_args:
        a, b = _offsets(t[2]), _offsets(j[2])
        assert (a["crc_ok"], a["sync"]) == (b["crc_ok"], b["sync"])
        assert abs(float(a["cfo"]) - float(b["cfo"])) <= 2e-6
        assert abs(float(a["time_offset"]) - float(b["time_offset"])) <= 2e-3
    return t


# ---------------------------------------------------------------------------
# tx_runner / rx_runner (tests/test_runners.py's cases)
# ---------------------------------------------------------------------------

def test_tx_rx_roundtrip(tmp_path, capfd):
    rc, out, err = both_runners(["--payload=deadbeefcafe", "--sf=7"],
                                ["--sf=7", "--report-offsets"], tmp_path, capfd)
    assert read_iq(tmp_path / "port.iq").size == 14 * 128
    assert rc == 0 and out.strip().splitlines()[-1] == "deadbeefcafe"
    assert "sync=0x12" in err


def test_rx_integrated_quirk(tmp_path, capfd):
    rc, out, _ = both_runners(["--payload=deadbeef"], ["--integrated"], tmp_path, capfd)
    assert rc == 0 and out.strip().splitlines()[-1] == "deadbeef"


def test_rx_raw_dechirped_input(tmp_path, capfd):
    """--raw: already-dechirped input, written by the JAX modem."""
    from lora_phy_tpu.models import modem as jmodem

    p = LoraParams(sf=7)
    iq = np.asarray(jmodem.dechirp(jmodem.modulate(
        jmodem.encode(np.frombuffer(bytes.fromhex("0badf00d"), np.uint8)), p), p))
    path = tmp_path / "raw.iq"
    write_iq(path, iq)
    j = run_cli(jrr.main, [f"--in={path}", "--raw"], capfd)
    t = run_cli(trr.main, [f"--in={path}", "--raw"] + CPU, capfd)
    assert t[0] == j[0] == 0 and t[1] == j[1] and t[1].strip() == "0badf00d"


def test_iqio_stdin_stdout_format(tmp_path, capfdbinary):
    x = (np.arange(8) + 1j * np.arange(8)).astype(np.complex64)
    path = tmp_path / "t.iq"
    write_iq(path, x)
    raw = np.fromfile(path, dtype=np.float32)
    np.testing.assert_array_equal(raw[0::2], x.real)
    np.testing.assert_array_equal(raw[1::2], x.imag)
    np.testing.assert_array_equal(read_iq(path), x)
    # --stdout writes the same bytes as the JAX runner
    assert jtr.main(["--payload=0102", "--stdout"]) == 0
    jax_bytes = capfdbinary.readouterr().out
    assert ttr.main(["--payload=0102", "--stdout"] + CPU) == 0
    assert capfdbinary.readouterr().out == jax_bytes and len(jax_bytes) == 6 * 128 * 8


def test_tx_rx_nondefault_params(tmp_path, capfd):
    flags = ["--sf=9", "--bw=250000", "--osr=2"]
    rc, out, _ = both_runners(["--payload=0011aabb"] + flags, flags, tmp_path, capfd)
    assert read_iq(tmp_path / "port.iq").size == (4 * 2 + 2) * 512 * 2
    assert rc == 0 and len(out.strip().splitlines()[-1]) == 8


def test_tx_continuous_chirp_flag(tmp_path, capfd):
    outs = {}
    for name, extra in (("a", []), ("b", ["--continuous-chirp"]),
                        ("c", ["--osr=2", "--continuous-chirp"])):
        for pkg, main, dev in (("j", jtr.main, []), ("t", ttr.main, CPU)):
            path = tmp_path / f"{pkg}{name}.iq"
            assert run_cli(main, ["--payload=deadbeef", f"--out={path}"] + extra + dev,
                           capfd)[0] == 0
            outs[pkg + name] = path.read_bytes()
    for name in "abc":
        assert outs["t" + name] == outs["j" + name]
    assert outs["ta"] == outs["tb"]
    ref, cont = read_iq(tmp_path / "ta.iq"), read_iq(tmp_path / "tc.iq")
    assert cont.size == 2 * ref.size and not np.array_equal(cont[::2], ref)


@pytest.mark.parametrize("args", [
    ["--sf"], ["--sf=abc"], ["--bogus=1"], ["stray"], ["--bw=300000"],
])
def test_runner_flag_errors(args, tmp_path, capfd):
    """Bare value flags, bad values and unknown flags: one line, exit 1,
    as the JAX runners."""
    for jmain, tmain, extra in ((jtr.main, ttr.main, ["--payload=01"]),
                                (jrr.main, trr.main, [])):
        j = run_cli(jmain, extra + args, capfd)
        t = run_cli(tmain, extra + args + CPU, capfd)
        assert t[0] == j[0] == 1
        assert t[2] == j[2] and len(t[2].strip().splitlines()) == 1


def test_runner_input_errors(tmp_path, capfd):
    short = tmp_path / "short.iq"
    write_iq(short, np.ones(100, np.complex64))
    for jmain, tmain, args in ((jtr.main, ttr.main, ["--payload=abc"]),
                               (jtr.main, ttr.main, []),
                               (jrr.main, trr.main, [f"--in={short}"])):
        j = run_cli(jmain, args, capfd)
        t = run_cli(tmain, args + CPU, capfd)
        assert t[0] == j[0] == 1 and t[2] == j[2]


def test_default_device_needs_a_card(tmp_path, capfd):
    """Every runner computes on the first CUDA card by default: without
    one it prints one line naming --device=cpu and exits 1, and an
    unknown --device value is a usage error."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from lora_phy_tpu_torch.runners import awgn_sweep, gr_decode

    iq = tmp_path / "x.iq"
    write_iq(iq, np.zeros(4096, np.complex64))
    for main, args in ((ttr.main, ["--payload=01"]), (trr.main, [f"--in={iq}"]),
                       (ttx.main, ["--payload=01", f"--out={tmp_path / 'o.iq'}"]),
                       (trx.main, [f"--in={iq}"]), (gr_decode.main, [f"--in={iq}"]),
                       (awgn_sweep.main, [f"--out={tmp_path / 'sw'}"])):
        rc, out, err = run_cli(main, args, capfd)
        assert rc == 1 and out == "", main
        assert err.strip().splitlines() == [
            "no CUDA device: pass --device=cpu to run on the CPU"], main
        rc, _, err = run_cli(main, args + ["--device=cuda:0"], capfd)
        assert rc == 1 and "--device=cpu" in err
        rc, _, err = run_cli(main, args + ["--device=tpu9"], capfd)
        assert rc == 1 and "Invalid value for --device" in err


# ---------------------------------------------------------------------------
# Checkpoints resume across the packages
# ---------------------------------------------------------------------------

def _split_stream(tmp_path, raw, cut):
    a, b = tmp_path / "a.iq", tmp_path / "b.iq"
    a.write_bytes(raw[:cut])
    b.write_bytes(raw[cut:])
    return a, b


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax"),
                                          ("port", "port")])
def test_checkpoint_resumes_across_packages(first, second, tmp_path, capfd):
    """The single-device carry file (re, im, base, reported, n_frames):
    a stream split inside its second frame decodes each frame once, at
    its true start, whichever package wrote the checkpoint."""
    p = LoraParams(sf=7)
    rng = np.random.RandomState(3)
    payloads = [rng.randint(0, 256, 16).astype(np.uint8) for _ in range(3)]
    sig, starts = _make_stream(payloads, p, gaps=[700, 900, 1100])
    a, b = _split_stream(tmp_path, _interleave(sig), (starts[1] + 400) * 8)
    ck = tmp_path / "ck.npz"
    mains = {"jax": (jrx.main, []), "port": (trx.main, CPU)}
    args = ["--sf=7", "--payload-len=16", "--block=8192", f"--checkpoint={ck}"]
    outs = []
    for pkg, part in ((first, a), (second, b)):
        main, dev = mains[pkg]
        rc, out, err = run_cli(main, [f"--in={part}"] + args + dev, capfd)
        assert rc == 0
        outs.append(out)
    assert "3 frames" in err                    # the count carried over
    lines = [l for l in "".join(outs).splitlines() if l.startswith("frame @")]
    assert sorted(int(l.split()[1][1:]) for l in lines) == starts
    for line, pay in zip(lines, payloads):
        assert f"payload={pay.tobytes().hex()}" in line
    with np.load(ck) as z:
        assert set(z.files) == {"re", "im", "base", "reported", "n_frames"}
        assert z["re"].dtype == np.float32 and z["reported"].shape[-1] == 3


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_adaptive_checkpoint_resumes_across_packages(first, second, tmp_path, capfd):
    """The adaptive tail file (tail_re, tail_im, consumed, n_frames)."""
    plist = tmp_path / "p.txt"
    pays = ["aabbccdd", "00112233445566"]
    plist.write_text("".join(h + "\n" for h in pays))
    sfile = tmp_path / "c.iq"
    assert run_cli(ttx.main, [f"--payloads={plist}", "--coded", "--crc", "--gap=1000",
                              f"--out={sfile}"] + CPU, capfd)[0] == 0
    a, b = _split_stream(tmp_path, sfile.read_bytes(), (1000 + 6000 + 1000 + 800) * 8)
    ck = tmp_path / "ck.npz"
    mains = {"jax": (jrx.main, []), "port": (trx.main, CPU)}
    outs = []
    for pkg, part in ((first, a), (second, b)):
        main, dev = mains[pkg]
        rc, out, err = run_cli(main, [f"--in={part}", "--sf=7", "--adaptive",
                                      f"--checkpoint={ck}"] + dev, capfd)
        assert rc == 0
        outs.append(out)
    lines = [l for l in "".join(outs).splitlines() if l.startswith("frame @")]
    assert len(lines) == 2 and "2 frames" in err
    for line, hx in zip(lines, pays):
        assert f"payload={hx}" in line and "crc=ok" in line
    with np.load(ck) as z:
        assert set(z.files) == {"tail_re", "tail_im", "consumed", "n_frames"}


def test_rx_stream_wideband_soft_and_json(tmp_path, capfd):
    """--channels=K with --soft (ML detection on every channel's spectra)
    and with --json (the channel key): the JAX runner's lines."""
    from lora_phy_tpu.models import modem as jmodem
    from lora_phy_tpu.models import stream as jstream
    from lora_phy_tpu.ops.channelizer import synthesize_channels_planar
    from test_torch_rx_stream import both_rx

    p = LoraParams(sf=7)
    k = 4
    rng = np.random.RandomState(9)
    pays = [rng.randint(0, 256, 16).astype(np.uint8) for _ in range(2)]
    frames = [np.asarray(jstream.frame_modulate(np.asarray(jmodem.encode(x), np.int32), p))
              for x in pays]
    chans = np.zeros((k, max(f.size for f in frames) + 3000), np.complex64)
    chans[1, 600:600 + frames[0].size] = frames[0]
    chans[3, 1400:1400 + frames[1].size] = frames[1]
    wr, wi = synthesize_channels_planar(chans.real.astype(np.float32),
                                        chans.imag.astype(np.float32), k, taps_per_branch=15)
    path = tmp_path / "wb.iq"
    path.write_bytes(_interleave(np.asarray(wr) + 1j * np.asarray(wi)))
    for extra in (["--soft"], ["--json"]):
        rc, out, err = both_rx([f"--in={path}", "--sf=7", "--payload-len=16",
                                f"--channels={k}", "--block=65536", *extra], capfd)
        assert rc == 0 and "2 frames" in err
        assert all(x.tobytes().hex() in out for x in pays)


# ---------------------------------------------------------------------------
# gr_decode and awgn_sweep
# ---------------------------------------------------------------------------

def test_gr_decode_runner_vs_jax(tmp_path, capfd, monkeypatch):
    """Two frames in gr-lora_sdr's convention (the JAX encoder's symbols,
    each symbol chirp starting at phase 0 as gr's modulator builds it) in
    one capture: the port's gr_decode prints the JAX runner's lines, hard
    and soft, and exits 1 on a capture without frames."""
    from lora_phy_tpu.models import gr_interop as jgr
    from lora_phy_tpu.models import stream as jstream
    from lora_phy_tpu.runners import gr_decode as jgd
    from lora_phy_tpu_torch.runners import gr_decode as tgd

    lattice = jstream.frame_modulate

    def gr_modulate(symbols, params, preamble_len=8, **kw):
        return lattice(symbols, params, preamble_len, symbol_phase_carry=False)

    monkeypatch.setattr(jgr.stream, "frame_modulate", gr_modulate)
    p = LoraParams(sf=7)
    parts = [np.zeros(700, np.complex64)]
    for k, cr in enumerate((1, 3)):
        parts += [np.asarray(jgr.encode_frame(b"hello world: %d" % k, p, cr=cr)),
                  np.zeros(900, np.complex64)]
    path = tmp_path / "gr.iq"
    write_iq(path, np.concatenate(parts))
    for extra in ([], ["--soft"]):
        j = run_cli(jgd.main, [f"--in={path}"] + extra, capfd)
        t = run_cli(tgd.main, [f"--in={path}"] + extra + CPU, capfd)
        assert t == j
        assert t[0] == 0 and t[1].count("crc=ok") == 2 and "hello world: 1" in t[1]
    empty = tmp_path / "empty.iq"
    write_iq(empty, np.zeros(8192, np.complex64))
    t = run_cli(tgd.main, [f"--in={empty}"] + CPU, capfd)
    assert t == run_cli(jgd.main, [f"--in={empty}"], capfd) and t[0] == 1


def test_awgn_sweep_runner(tmp_path, capfd):
    """The port's awgn_sweep writes the JAX runner's CSV schema and rows
    (values from its own draws): error-free at 12 dB."""
    from lora_phy_tpu.runners import awgn_sweep as jas
    from lora_phy_tpu_torch.runners import awgn_sweep as tas

    args = ["--packets=8", "--payload-bytes=4", "--snr-start=10", "--snr-stop=12",
            "--snr-step=2"]
    assert run_cli(jas.main, args + [f"--out={tmp_path / 'j'}"], capfd)[0] == 0
    rc, _, err = run_cli(tas.main, args + [f"--out={tmp_path / 't'}"] + CPU, capfd)
    assert rc == 0 and "sweep written to" in err
    jl = (tmp_path / "j" / "awgn_sweep.csv").read_text().splitlines()
    tl = (tmp_path / "t" / "awgn_sweep.csv").read_text().splitlines()
    assert tl[0] == jl[0] == "sf,bw,cr,snr_db,ber,per"
    assert [r.split(",")[:4] for r in tl] == [r.split(",")[:4] for r in jl]
    assert all(r.split(",")[4:] == ["0.0", "0.0"] for r in tl[1:] if r.split(",")[3] == "12.0")


# ---------------------------------------------------------------------------
# python -m, in a process of its own: no JAX, and a real shell pipe
# ---------------------------------------------------------------------------

def _imported(stderr: str) -> set[str]:
    """Module names of ``python -X importtime``'s report."""
    mods = set()
    for line in stderr.splitlines():
        if line.startswith("import time:") and "|" in line:
            mods.add(line.rsplit("|", 1)[1].strip())
    return mods


def _no_jax(mods: set[str]) -> None:
    assert mods, "no import report"
    assert "lora_phy_tpu_torch.runners._cli" in mods
    bad = sorted(m for m in mods if m == "jax" or m.startswith("jax.")
                 or m == "lora_phy_tpu" or m.startswith("lora_phy_tpu."))
    assert not bad, bad


def test_python_m_runs_without_jax(tmp_path):
    """``python -m lora_phy_tpu_torch.runners.rx_stream --device=cpu`` in a
    process of its own decodes the stream and imports neither jax nor
    anything of lora_phy_tpu (``-X importtime`` lists every import); so
    does a real ``tx_stream | rx_stream`` shell pipe."""
    p = LoraParams(sf=7)
    rng = np.random.RandomState(3)
    payloads = [rng.randint(0, 256, 16).astype(np.uint8) for _ in range(3)]
    sig, starts = _make_stream(payloads, p, gaps=[700, 900, 1100])
    path = tmp_path / "s.iq"
    path.write_bytes(_interleave(sig))
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "HOME": str(tmp_path),
           "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "lora_phy_tpu_torch.runners.rx_stream",
         f"--in={path}", "--payload-len=16", "--device=cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert [int(l.split()[1][1:]) for l in lines] == starts
    assert [l.split("payload=")[1] for l in lines] == [x.tobytes().hex() for x in payloads]
    _no_jax(_imported(proc.stderr))

    hexes = [x.tobytes().hex() for x in payloads]
    tx = (f"{sys.executable} -m lora_phy_tpu_torch.runners.tx_stream --payloads=- "
          f"--gap=900 --format=ci16 --device=cpu")
    rx = (f"{sys.executable} -X importtime -m lora_phy_tpu_torch.runners.rx_stream "
          f"--format=ci16 --payload-len=16 --device=cpu")
    proc = subprocess.run(f"{tx} | {rx}", shell=True, input="\n".join(hexes) + "\n",
                          cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert [l.split("payload=")[1] for l in proc.stdout.splitlines()] == hexes
    assert "3 frames" in proc.stderr
    _no_jax(_imported(proc.stderr))


@pytest.mark.gpu
def test_rx_stream_on_card_equals_cpu(tmp_path, capfd):
    """rx_stream --device=cuda:0 on a short stream prints the CPU run's
    lines (decisions exactly, snr/sro within a printed digit)."""
    from _torch_util import cuda_device

    cuda_device()
    p = LoraParams(sf=7)
    rng = np.random.RandomState(3)
    payloads = [rng.randint(0, 256, 16).astype(np.uint8) for _ in range(3)]
    sig, starts = _make_stream(payloads, p, gaps=[700, 900, 1100])
    path = tmp_path / "s.iq"
    path.write_bytes(_interleave(sig))
    for extra in ([], ["--soft"], ["--robust"]):
        args = [f"--in={path}", "--payload-len=16", "--block=8192"] + extra
        card = run_cli(trx.main, args + ["--device=cuda:0"], capfd)
        cpu = run_cli(trx.main, args + CPU, capfd)
        assert card[0] == cpu[0] == 0 and card[2] == cpu[2]
        lines = assert_same_lines(card[1], cpu[1])
        assert [int(l.split()[1][1:]) for l in lines] == starts
