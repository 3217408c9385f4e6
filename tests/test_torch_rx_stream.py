"""Port parity of the streaming command line: lora_phy_tpu_torch.runners
``rx_stream`` / ``tx_stream`` on each case of ``tests/test_rx_stream.py``,
run in-process through ``main(argv)`` beside the JAX runners on the same
files and flags (the port's with ``--device=cpu``).

Compared exactly: the exit code, every decision field of every line
(``@start``, ``ch=``, ``sf=``, ``sync``, ``cfo_bins``, ``sic=``,
``payload``, ``len``, ``cr``, ``crc``) and the ``N frames`` summary on
stderr. Within stated tolerances: the printed ``snr``/``sro`` (one
printed digit), the JSON ``snr_db``/``sro_ppm`` and ``margin=``
(``_torch_util``). TX files are byte-equal. ``--mesh`` is not ported: the
port exits 1."""

import io
import json
import re
import sys

import numpy as np
import pytest

from _torch_util import assert_same_lines, run_cli
from lora_phy_tpu.models import modem, stream
from lora_phy_tpu.runners import rx_stream as jrx
from lora_phy_tpu.runners import tx_stream as jtx
from lora_phy_tpu.utils.params import LoraParams
from lora_phy_tpu_torch.runners import rx_stream as trx
from lora_phy_tpu_torch.runners import tx_stream as ttx
from test_rx_stream import _interleave, _make_stream

CPU = ["--device=cpu"]


def _summary(err: str) -> list[str]:
    """The stderr summary line(s): ``N frames...``."""
    return [l for l in err.splitlines() if " frames" in l]


def both_rx(args, capfd, stdin_bytes=None, monkeypatch=None):
    """rx_stream of both packages on ``args``; the port's (rc, out, err)
    after checking it against JAX's."""
    def run(main, extra):
        if stdin_bytes is not None:
            class _Stdin:
                buffer = io.BytesIO(stdin_bytes)
            monkeypatch.setattr(sys, "stdin", _Stdin())
        return run_cli(main, list(args) + extra, capfd)

    j = run(jrx.main, [])
    t = run(trx.main, CPU)
    assert t[0] == j[0]
    assert_same_lines(t[1], j[1])
    assert _summary(t[2]) == _summary(j[2])
    return t


def both_tx(args, tmp_path, capfd, name="s.iq"):
    """tx_stream of both packages to two files; asserts equal exit codes
    and equal bytes; returns the port's file (or None on failure)."""
    jp, tp = tmp_path / f"jax_{name}", tmp_path / name
    j = run_cli(jtx.main, list(args) + [f"--out={jp}"], capfd)
    t = run_cli(ttx.main, list(args) + [f"--out={tp}"] + CPU, capfd)
    assert t[0] == j[0]
    assert _summary(t[2]) == _summary(j[2])
    if t[0] != 0:
        return None
    assert tp.read_bytes() == jp.read_bytes()
    return tp


@pytest.fixture
def frames_fixture(tmp_path):
    p = LoraParams(sf=7)
    rng = np.random.RandomState(3)
    payloads = [rng.randint(0, 256, 16).astype(np.uint8) for _ in range(3)]
    sig, starts = _make_stream(payloads, p, gaps=[700, 900, 1100])
    path = tmp_path / "s.iq"
    path.write_bytes(_interleave(sig))
    return p, payloads, sig, starts, path


def test_rx_stream_file(capfd, frames_fixture):
    p, payloads, sig, starts, path = frames_fixture
    rc, out, err = both_rx([f"--in={path}", "--sf=7", "--payload-len=16",
                            "--block=8192"], capfd)
    lines = [l for l in out.splitlines() if l.startswith("frame @")]
    assert rc == 0 and len(lines) == 3 and "3 frames" in err
    for line, pay, s in zip(lines, payloads, starts):
        assert f"@{s} " in line and "sync=0x12" in line
        assert f"payload={pay.tobytes().hex()}" in line


def test_rx_stream_stdin_ci16(capfd, frames_fixture, monkeypatch):
    p, payloads, sig, starts, _ = frames_fixture
    scaled = np.empty(sig.size * 2, np.int16)
    scaled[0::2] = np.round(sig.real * 32767).astype(np.int16)
    scaled[1::2] = np.round(sig.imag * 32767).astype(np.int16)
    rc, out, _ = both_rx(["--sf=7", "--payload-len=16", "--block=8192",
                          "--format=ci16"], capfd, scaled.tobytes(), monkeypatch)
    lines = [l for l in out.splitlines() if l.startswith("frame @")]
    assert rc == 0 and len(lines) == 3
    for line, pay in zip(lines, payloads):
        assert f"payload={pay.tobytes().hex()}" in line


def test_tx_stream_to_rx_stream_roundtrip(tmp_path, capfd):
    payloads = ["deadbeefcafef00d" * 2, "0102030405060708" * 2,
                "a5a5a5a5a5a5a5a5" * 2]
    plist = tmp_path / "p.txt"
    plist.write_text("\n".join(payloads) + "\n")
    for fmt in ("cf32", "ci8"):
        sfile = both_tx([f"--payloads={plist}", "--sf=7", "--gap=900",
                         f"--format={fmt}"], tmp_path, capfd, f"s_{fmt}.iq")
        rc, out, _ = both_rx([f"--in={sfile}", "--sf=7", "--payload-len=16",
                              "--block=16384", f"--format={fmt}"], capfd)
        lines = [l for l in out.splitlines() if l.startswith("frame @")]
        assert [l.split("payload=")[1] for l in lines] == payloads, fmt
    bad = tmp_path / "bad.txt"
    bad.write_text("zzzz\n")
    assert both_tx([f"--payloads={bad}"], tmp_path, capfd, "x.iq") is None


def test_rx_stream_wideband_channels(tmp_path, capfd):
    from lora_phy_tpu.ops.channelizer import synthesize_channels_planar

    p = LoraParams(sf=7)
    k = 4
    rng = np.random.RandomState(9)
    pays = [rng.randint(0, 256, 16).astype(np.uint8) for _ in range(2)]
    frames = [np.asarray(stream.frame_modulate(
        np.asarray(modem.encode(pv), np.int32), p)) for pv in pays]
    L = max(f.size for f in frames) + 3000
    chans = np.zeros((k, L), np.complex64)
    chans[1, 600:600 + frames[0].size] = frames[0]
    chans[3, 1400:1400 + frames[1].size] = frames[1]
    wr, wi = synthesize_channels_planar(
        chans.real.astype(np.float32), chans.imag.astype(np.float32), k,
        taps_per_branch=15)
    path = tmp_path / "wb.iq"
    path.write_bytes(_interleave(np.asarray(wr) + 1j * np.asarray(wi)))
    rc, out, err = both_rx([f"--in={path}", "--sf=7", "--payload-len=16",
                            f"--channels={k}", "--block=65536"], capfd)
    assert rc == 0 and "2 frames" in err
    lines = [l for l in out.splitlines() if l.startswith("frame ")]
    by_ch = {int(l.split("ch=")[1].split()[0]): l for l in lines}
    assert set(by_ch) == {1, 3}
    assert f"payload={pays[0].tobytes().hex()}" in by_ch[1]
    assert f"payload={pays[1].tobytes().hex()}" in by_ch[3]


def test_rx_stream_blind_sf(tmp_path, capfd):
    rng = np.random.RandomState(21)
    pls = {7: rng.randint(0, 256, 8).astype(np.uint8),
           9: rng.randint(0, 256, 8).astype(np.uint8)}
    parts, pos, starts = [], 0, {}
    for sf in (7, 9):
        p = LoraParams(sf=sf)
        parts.append(np.zeros(5 * 128, np.complex64))
        pos += 5 * 128
        fr = np.asarray(stream.frame_modulate(
            np.asarray(modem.encode(pls[sf]), np.int32), p))
        starts[sf] = pos
        parts.append(fr)
        pos += fr.size
    parts.append(np.zeros(4096, np.complex64))
    path = tmp_path / "mix.iq"
    path.write_bytes(_interleave(np.concatenate(parts)))
    rc, out, _ = both_rx([f"--in={path}", "--sf=auto", "--payload-len=8",
                          "--quiet"], capfd)
    lines = out.strip().splitlines()
    assert rc == 0 and len(lines) == 2
    for sf, line in zip((7, 9), lines):
        assert f"sf={sf} " in line and f"@{starts[sf]} " in line
        assert line.endswith(pls[sf].tobytes().hex())


def _collision(p, seed, n_bytes, weak):
    rng = np.random.RandomState(seed)
    pay_a = rng.randint(0, 256, n_bytes).astype(np.uint8)
    pay_b = rng.randint(0, 256, n_bytes).astype(np.uint8)
    fa = np.asarray(stream.frame_modulate(np.asarray(modem.encode(pay_a), np.int32), p))
    fb = weak * np.asarray(stream.frame_modulate(np.asarray(modem.encode(pay_b), np.int32), p))
    return pay_a, pay_b, fa, fb.astype(np.complex64)


def test_rx_stream_sic_collision(tmp_path, capfd):
    p = LoraParams(sf=7)
    pay_a, pay_b, fa, fb = _collision(p, 11, 8, 0.25)
    off_a, off_b = 2 * p.step, 7 * p.step
    sig = np.zeros(off_b + fb.size + 6 * p.step, np.complex64)
    sig[off_a: off_a + fa.size] += fa
    sig[off_b: off_b + fb.size] += fb
    path = tmp_path / "collision.iq"
    path.write_bytes(_interleave(sig))
    args = [f"--in={path}", "--sf=7", "--payload-len=8"]
    _, plain, _ = both_rx(args, capfd)
    assert f"payload={pay_b.tobytes().hex()}" not in plain
    rc, out, err = both_rx(args + ["--sic"], capfd)
    lines = [l for l in out.splitlines() if l.startswith("frame @")]
    assert rc == 0 and len(lines) == 2 and "2 frames" in err
    assert f"@{off_a} " in lines[0] and "sic=0" in lines[0]
    assert f"@{off_b} " in lines[1] and "sic=1" in lines[1]
    assert f"payload={pay_b.tobytes().hex()}" in lines[1]


def test_rx_stream_flag_conflicts(capfd):
    """Every usage error of the JAX runner is one of the port's too (exit
    1, before any input is read)."""
    for args in (["--sic", "--sf=auto"], ["--cad", "--channels=4"],
                 ["--adaptive", "--sic"], ["--adaptive", "--sf=auto"],
                 ["--soft", "--sic"], ["--robust", "--adaptive"],
                 ["--format=cs8"], ["--mesh=2", "--sic"], ["--bogus"], ["--sf"]):
        j = run_cli(jrx.main, args, capfd)
        t = run_cli(trx.main, args + CPU, capfd)
        assert j[0] == t[0] == 1, args
        assert t[2].strip().splitlines()[0] == j[2].strip().splitlines()[0], args


def test_rx_stream_sic_wideband(tmp_path, capfd):
    from lora_phy_tpu.ops.channelizer import synthesize_channels_planar

    p = LoraParams(sf=7)
    k = 4
    pay_a, pay_b, fa, fb = _collision(p, 33, 6, 0.25)
    L = fa.size + 14 * p.step
    chans = np.zeros((k, L), np.complex64)
    chans[2, 2 * p.step: 2 * p.step + fa.size] += fa
    chans[2, 7 * p.step: 7 * p.step + fb.size] += fb
    wr, wi = synthesize_channels_planar(
        chans.real.astype(np.float32), chans.imag.astype(np.float32), k,
        taps_per_branch=15)
    path = tmp_path / "wbsic.iq"
    path.write_bytes(_interleave(np.asarray(wr) + 1j * np.asarray(wi)))
    rc, out, err = both_rx([f"--in={path}", "--sf=7", "--payload-len=6",
                            f"--channels={k}", "--taps=15", "--sic",
                            "--thresh=-15", "--block=131072"], capfd)
    lines = [l for l in out.splitlines() if l.startswith("frame ")]
    assert rc == 0 and "2 frames" in err and len(lines) == 2
    assert all("ch=2" in l for l in lines)
    assert "sic=0" in lines[0] and f"payload={pay_a.tobytes().hex()}" in lines[0]
    assert "sic=1" in lines[1] and f"payload={pay_b.tobytes().hex()}" in lines[1]


def test_invert_iq_downlink_roundtrip(tmp_path, capfd):
    pay = bytes(range(16)).hex()
    sfile = both_tx([f"--payload={pay}", "--count=2", "--gap=900", "--invert-iq"],
                    tmp_path, capfd, "down.iq")
    _, plain, _ = both_rx([f"--in={sfile}", "--sf=7", "--payload-len=16"], capfd)
    assert "frame @" not in plain
    rc, out, err = both_rx([f"--in={sfile}", "--sf=7", "--payload-len=16",
                            "--invert-iq"], capfd)
    lines = [l for l in out.splitlines() if l.startswith("frame @")]
    assert rc == 0 and len(lines) == 2 and "2 frames" in err
    assert all(f"payload={pay}" in l for l in lines)


def test_rx_stream_cad_gate(tmp_path, capfd, frames_fixture):
    p, payloads, sig, starts, _ = frames_fixture
    path = tmp_path / "sparse.iq"
    path.write_bytes(_interleave(np.concatenate([np.zeros(40000, np.complex64), sig])))
    args = [f"--in={path}", "--sf=7", "--payload-len=16", "--block=8192"]
    _, plain, _ = both_rx(args, capfd)
    rc, gated, err = both_rx(args + ["--cad"], capfd)
    assert rc == 0 and gated == plain and len(gated.splitlines()) == 3
    m = re.search(r"\((\d+) buffers CAD-skipped\)", err)
    assert m and int(m.group(1)) >= 2


def test_rx_stream_wideband_blind_sf_compose(tmp_path, capfd):
    from lora_phy_tpu.ops.channelizer import synthesize_channels_planar

    k = 4
    rng = np.random.RandomState(17)
    pay7 = rng.randint(0, 256, 8).astype(np.uint8)
    pay8 = rng.randint(0, 256, 8).astype(np.uint8)
    f7 = np.asarray(stream.frame_modulate(
        np.asarray(modem.encode(pay7), np.int32), LoraParams(sf=7)))
    f8 = np.asarray(stream.frame_modulate(
        np.asarray(modem.encode(pay8), np.int32), LoraParams(sf=8)))
    L = max(f7.size, f8.size) + 16 * 256
    chans = np.zeros((k, L), np.complex64)
    chans[0, 500:500 + f7.size] = f7
    chans[2, 900:900 + f8.size] = f8
    wr, wi = synthesize_channels_planar(
        chans.real.astype(np.float32), chans.imag.astype(np.float32), k,
        taps_per_branch=15)
    path = tmp_path / "wbblind.iq"
    path.write_bytes(_interleave(np.asarray(wr) + 1j * np.asarray(wi)))
    rc, out, err = both_rx([f"--in={path}", "--sf=auto", "--payload-len=8",
                            f"--channels={k}", "--block=131072", "--taps=15",
                            "--thresh=-15"], capfd)
    assert rc == 0 and "2 frames" in err
    lines = [l for l in out.splitlines() if l.startswith("frame ")]
    tags = {(l.split("sf=")[1].split()[0], l.split("ch=")[1].split()[0]) for l in lines}
    assert tags == {("7", "0"), ("8", "2")}


def test_preamble_length_flag_roundtrip(tmp_path, capfd):
    pay = "c0ffee00112233"
    for mode in ("plain", "coded"):
        args = [f"--payload={pay}", "--preamble=12", "--gap=1000"]
        if mode == "coded":
            args += ["--coded", "--crc"]
        sfile = both_tx(args, tmp_path, capfd, f"lp_{mode}.iq")
        rx = [f"--in={sfile}", "--sf=7", "--preamble=12"]
        rx += ["--adaptive"] if mode == "coded" else ["--payload-len=7"]
        rc, out, _ = both_rx(rx, capfd)
        lines = [l for l in out.splitlines() if l.startswith("frame @")]
        assert rc == 0 and len(lines) == 1 and f"payload={pay}" in lines[0]
        assert "@1000 " in lines[0]


def test_rx_stream_json_output(tmp_path, capfd, frames_fixture):
    p, payloads, sig, starts, path = frames_fixture
    rc, out, _ = both_rx([f"--in={path}", "--sf=7", "--payload-len=16", "--json"],
                         capfd)
    recs = [json.loads(l) for l in out.splitlines() if l.strip()]
    assert [r["start"] for r in recs] == starts
    assert [r["payload"] for r in recs] == [pay.tobytes().hex() for pay in payloads]
    coded = both_tx(["--payload=beef", "--coded", "--crc"], tmp_path, capfd, "c.iq")
    for extra in ([], ["--soft"]):
        rc, out, _ = both_rx([f"--in={coded}", "--sf=7", "--adaptive", "--json"] + extra,
                             capfd)
        (rec,) = [json.loads(l) for l in out.splitlines() if l.strip()]
        assert rec["payload"] == "beef" and rec["crc"] == "ok"
        assert rec["len"] == 2 and rec["cr"] == "4/5"


def test_rx_stream_frontend_correct(tmp_path, capfd):
    from lora_phy_tpu.ops.impair import apply_frontend

    p = LoraParams(sf=7)
    pay_a, pay_b, fa, fb = _collision(p, 2, 6, 0.07)
    s = np.zeros(7 * p.step + fb.size + 4 * p.step, np.complex64)
    s[2 * p.step: 2 * p.step + fa.size] += fa
    s[7 * p.step: 7 * p.step + fb.size] += fb
    bad = np.asarray(apply_frontend(s, dc=0.05 - 0.03j, gain_imbalance=1.2,
                                    phase_skew_deg=6.0))
    path = tmp_path / "fe.iq"
    path.write_bytes(_interleave(bad))
    args = [f"--in={path}", "--sf=7", "--payload-len=6", "--sic"]
    _, raw_out, _ = both_rx(args, capfd)
    assert f"payload={pay_b.tobytes().hex()}" not in raw_out
    rc, out, _ = both_rx(args + ["--frontend-correct"], capfd)
    assert f"payload={pay_a.tobytes().hex()}" in out
    assert f"payload={pay_b.tobytes().hex()}" in out


def test_rx_stream_mesh_mode_not_ported(capfd, frames_fixture):
    """--mesh=T (time-sharded receive) is not ported yet: one line on
    stderr and exit 1, for any --mesh > 0; its flag conflicts stay the
    JAX runner's."""
    *_, path = frames_fixture
    for extra in (["--mesh=4"], ["--mesh=2", "--soft"], ["--mesh=1"]):
        rc, out, err = run_cli(trx.main, [f"--in={path}", "--sf=7", "--payload-len=16",
                                          "--block=16384", *extra] + CPU, capfd)
        assert rc == 1 and out == ""
        assert len(err.strip().splitlines()) == 1 and "not ported" in err
    rc, _, err = run_cli(trx.main, [f"--in={path}", "--sf=auto", "--mesh=2"] + CPU, capfd)
    assert rc == 1 and "--mesh time-shards" in err


def test_rx_stream_soft_block_mode(capfd, frames_fixture):
    p, payloads, sig, starts, path = frames_fixture
    for extra in (["--sf=7"], ["--sf=auto"]):
        rc, out, _ = both_rx([f"--in={path}", "--payload-len=16", "--soft", "--quiet",
                              *extra], capfd)
        lines = out.strip().splitlines()
        assert rc == 0 and len(lines) == len(payloads)
        for line, pay in zip(lines, payloads):
            assert line.endswith(pay.tobytes().hex())


def test_rx_stream_robust_and_any_sync(capfd, frames_fixture):
    """--robust (pre_acc=3) and --any-sync on the plain stream."""
    *_, path = frames_fixture
    for extra in (["--robust"], ["--any-sync"], ["--robust", "--soft", "--json"]):
        rc, out, _ = both_rx([f"--in={path}", "--sf=7", "--payload-len=16",
                              "--block=8192", *extra], capfd)
        assert rc == 0 and len(out.strip().splitlines()) == 3
