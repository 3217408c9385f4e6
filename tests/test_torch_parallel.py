"""Port parity of the time/channel-sharded receivers: lora_phy_tpu_torch.
parallel on a mesh of eight CPU shards against ``lora_phy_tpu.parallel``
on the JAX suite's eight virtual CPU devices, case for case with
``tests/test_parallel.py``.

Each case builds its inputs with numpy from a seed (through the JAX
package's TX where the JAX test does), runs the port's mesh at every
layout of the JAX case, and holds it against JAX's mesh at one layout and
against the port's single-device function at all of them. Compared
exactly: symbols, sync words, found sets, starts, decoded bytes, and the
frames of a resumed MeshStreamDemodulator against an uninterrupted run.
Within the
tolerances of ROADMAP Queue 3: cfo 1e-6 (1e-5 bins in the block
receiver), time_offset 2e-3, snr_db 1e-2 dB, sro_ppm 0.05 ppm, spectra
2e-5 of the frame's peak, against JAX and against the port's single
device alike. Every whole-frame estimate is at osr 1.

Not mirrored: ``test_no_retrace_steady_state`` (XLA's compile cache: the
port compiles nothing) and ``test_ota_capture_wideband_on_mesh`` (it
needs the absent reference capture through ``reference_dir``). JAX's
mesh results are computed once per module (``functools.cache``).
"""

import functools
import json
import warnings

import jax
import numpy as np
import pytest
import torch

from _torch_util import nn, tparams, tt
from lora_phy_tpu.models import coded as jcoded
from lora_phy_tpu.models import modem as jmodem
from lora_phy_tpu.models import stream as jstream
from lora_phy_tpu.models import sync as jsync
from lora_phy_tpu.ops import impair as jimpair
from lora_phy_tpu.ops import planar as jplanar
from lora_phy_tpu.parallel import mesh as jmeshlib
from lora_phy_tpu.parallel import stream as jps
from lora_phy_tpu.utils.params import LoraParams
from lora_phy_tpu_torch.models import coded as tcoded
from lora_phy_tpu_torch.models import modem as tmodem
from lora_phy_tpu_torch.models import soft as tsoft
from lora_phy_tpu_torch.models import sync as tsync
from lora_phy_tpu_torch.parallel import mesh as tmeshlib
from lora_phy_tpu_torch.parallel import stream as tps

CPU = torch.device("cpu")
P7 = LoraParams(sf=7)


@pytest.fixture(scope="module")
def jdevices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs


def tmesh(n_c, n_t):
    return tmeshlib.make_mesh(n_c, n_t, devices=[CPU] * (n_c * n_t))


def jmesh(n_c, n_t):
    return jmeshlib.make_mesh(n_channel=n_c, n_time=n_t,
                              devices=jax.devices()[:n_c * n_t])


def jput(x, m):
    return jax.device_put(np.asarray(x), jmeshlib.stream_sharding(m))


def _make_stream(n_channels, payload_len=32, seed=0):
    """test_parallel._make_stream: payloads and their dechirped frames."""
    rng = np.random.RandomState(seed)
    payloads = rng.randint(0, 256, (n_channels, payload_len)).astype(np.uint8)
    iq = jmodem.modulate(jmodem.encode(payloads), P7)
    return payloads, np.asarray(jmodem.dechirp(iq, P7))


def _planes(x):
    return (np.ascontiguousarray(x.real, np.float32),
            np.ascontiguousarray(x.imag, np.float32))


def frame_rows(blk, spec=None):
    """{(channel, start): fields} of a [C, K] BlockFrames' found lanes
    (either package), with the spectra row where given."""
    f = {k: nn(getattr(blk, k)) for k in blk._fields}
    s = None if spec is None else nn(spec)
    rows = {}
    for c, k in zip(*np.nonzero(f["found"])):
        row = {k2: f[k2][c, k] for k2 in f if k2 not in ("found", "start")}
        row["symbols"] = tuple(int(v) for v in row["symbols"])
        if s is not None:
            row["spectra"] = s[c, k]
        rows[(int(c), int(f["start"][c, k]))] = row
    return rows


def assert_same_frames(port, ref):
    """Same found frames at the same starts with the same decisions; the
    float fields within the stated tolerances (the port's mesh against its
    own single device too: a shard's batch is another shape, and the CPU
    GEMMs round a row differently with its place in the batch)."""
    assert set(port) == set(ref), (sorted(port), sorted(ref))
    for key, a in port.items():
        b = ref[key]
        assert a["symbols"] == b["symbols"], key
        assert int(a["sync"]) == int(b["sync"]) and int(a["cfo_bins"]) == int(b["cfo_bins"])
        assert abs(float(a["cfo"]) - float(b["cfo"])) <= 1e-5, key
        assert abs(float(a["time_offset"]) - float(b["time_offset"])) <= 2e-3, key
        assert abs(float(a["snr_db"]) - float(b["snr_db"])) <= 1e-2, key
        assert abs(float(a["sro_ppm"]) - float(b["sro_ppm"])) <= 0.05, key
        if "spectra" in a:
            peak = np.max(b["spectra"], axis=-1, keepdims=True)
            assert np.all(np.abs(a["spectra"] - b["spectra"]) <= 2e-5 * peak), key


# ---------------------------------------------------------------------------
# The mesh and its runner
# ---------------------------------------------------------------------------

def test_make_mesh_layouts_and_errors():
    m = tmeshlib.make_mesh(n_time=4, devices=[CPU] * 8)
    assert m.shape == {"channel": 2, "time": 4} and m.devices.shape == (2, 4)
    assert tmeshlib.make_mesh(devices=[CPU] * 8).shape == {"channel": 8, "time": 1}
    with pytest.raises(ValueError, match="mesh 3x2 != 8 devices"):
        tmeshlib.make_mesh(3, 2, devices=[CPU] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmeshlib.make_mesh()


def test_device_put_blocks_and_collectives():
    """Blocks are contiguous channel x time blocks (views on their own
    device); the runner's collectives: pmax per row, the masked ring
    permute both ways, shard 0's value broadcast."""
    m = tmesh(2, 4)
    x = torch.arange(2 * 16, dtype=torch.float32).reshape(2, 16)
    st = tmeshlib.device_put(x, tmeshlib.stream_sharding(m))
    assert torch.equal(st.blocks[1][2], x[1:2, 8:12])
    assert st.blocks[1][2].data_ptr() == x[1:2, 8:12].data_ptr()
    assert torch.equal(tmeshlib.join(st.blocks, -1, CPU), x)

    def body(shard, blk):
        mx = yield tmeshlib.pmax(blk.max())
        right = yield tmeshlib.ppermute(blk[0, :1], -1)
        left = yield tmeshlib.ppermute(blk[0, -1:], 1)
        first = yield tmeshlib.psum_first(blk[0, :1] + shard.t_idx)
        return mx, right, left, first

    grid = tmeshlib.run_shards(m, body, st.blocks)
    for c in range(2):
        for t in range(4):
            mx, right, left, first = grid[c][t]
            assert float(mx) == float(x[c].max())
            assert float(right) == (float(x[c, 4 * t + 4]) if t < 3 else 0.0)
            assert float(left) == (float(x[c, 4 * t - 1]) if t > 0 else 0.0)
            assert float(first) == float(x[c, 0])


def test_channel_sharded_equals_single(jdevices):
    """test_parallel.py:44 — a single-device function per channel block."""
    payloads, dech = _make_stream(8)
    jm = jmeshlib.make_mesh(n_channel=8, n_time=1, devices=jdevices)
    jres = jmodem.demodulate(jax.device_put(dech, jmeshlib.channel_sharding(jm)), P7)
    m = tmesh(8, 1)
    grid = tmeshlib.run_shards(
        m, lambda shard, x: tmodem.demodulate(x, tparams(P7)),
        tmeshlib.blocks_of(tt(dech), tmeshlib.channel_sharding(m)))
    syms = tmeshlib.join([[r.symbols for r in row] for row in grid], None, CPU)
    sync = tmeshlib.join([[r.sync_word for r in row] for row in grid], None, CPU)
    ref = tmodem.demodulate(tt(dech), tparams(P7))
    assert torch.equal(syms, ref.symbols) and torch.equal(sync, ref.sync_word)
    np.testing.assert_array_equal(nn(syms), nn(jres.symbols))
    np.testing.assert_array_equal(nn(sync), nn(jres.sync_word))


# ---------------------------------------------------------------------------
# The streaming demodulator
# ---------------------------------------------------------------------------

@functools.cache
def _jax_stream(layout, kind):
    """JAX's mesh result at ``layout`` for one of the stream cases."""
    n_c, n_t = layout
    m = jmesh(n_c, n_t)
    _, dech = _make_stream(n_c, payload_len=31)
    if kind == "shift":
        dech = np.asarray(jimpair.apply_time_shift(dech, 3))
    if kind == "loud":
        dech = dech * 2.5
    if kind == "planar":
        re, im = _planes(dech)
        out = jps.demodulate_stream_planar(jput(re, m), jput(im, m), P7, m)
    else:
        out = jps.demodulate_stream(jax.device_put(dech, jmeshlib.stream_sharding(m)),
                                    P7, m)
    return dech, tuple(nn(o) for o in out)


def _check_stream(layout, kind, jax_layout):
    n_c, n_t = layout
    _, dech = _make_stream(n_c, payload_len=31)
    if kind == "shift":
        dech = np.asarray(jimpair.apply_time_shift(dech, 3))
    if kind == "loud":
        dech = dech * 2.5
    m = tmesh(n_c, n_t)
    if kind == "planar":
        re, im = _planes(dech)
        syms, sync, cfo, to = tps.demodulate_stream_planar(tt(re), tt(im), tparams(P7), m)
    else:
        syms, sync, cfo, to = tps.demodulate_stream(tt(dech), tparams(P7), m)
    ref = tmodem.demodulate(tt(dech), tparams(P7))
    assert torch.equal(syms[..., 2:], ref.symbols)
    assert torch.equal(sync, ref.sync_word)
    assert torch.allclose(cfo, ref.cfo, rtol=0, atol=1e-6)
    assert torch.allclose(to, ref.time_offset, rtol=0, atol=1e-5)
    if layout == jax_layout:
        _, (jsyms, jsync, jcfo, jto) = _jax_stream(layout, kind)
        np.testing.assert_array_equal(nn(syms), jsyms)
        np.testing.assert_array_equal(nn(sync), jsync)
        np.testing.assert_allclose(nn(cfo), jcfo, rtol=0, atol=1e-6)
        np.testing.assert_allclose(nn(to), jto, rtol=0, atol=2e-3)
    return syms


@pytest.mark.parametrize("layout", [(1, 8), (2, 4), (4, 2)])
def test_time_sharded_stream_equals_single(jdevices, layout):
    """test_parallel.py:57 (the complex entry point)."""
    _check_stream(layout, "complex", (2, 4))


def test_time_sharded_with_timing_shift(jdevices):
    """test_parallel.py:73: a +3-sample shift makes every shard's window
    gather cross its right seam (the halo path)."""
    _check_stream((2, 4), "shift", (2, 4))


@pytest.mark.parametrize("layout", [(1, 8), (2, 4)])
def test_planar_time_sharded_stream_equals_single(jdevices, layout):
    """test_parallel.py:91."""
    _check_stream(layout, "planar", (1, 8))


def test_planar_time_sharded_with_timing_shift(jdevices):
    """test_parallel.py:112: the shift through the planar entry point, at
    a layout JAX runs once for the complex one."""
    n_c, n_t = 2, 4
    _, dech = _make_stream(n_c, payload_len=31)
    shifted = np.asarray(jimpair.apply_time_shift(dech, 3))
    re, im = _planes(shifted)
    syms, sync, cfo, to = tps.demodulate_stream_planar(tt(re), tt(im), tparams(P7),
                                                       tmesh(n_c, n_t))
    ref = tmodem.demodulate(tt(shifted), tparams(P7))
    assert torch.equal(syms[..., 2:], ref.symbols)
    assert torch.allclose(to, ref.time_offset, rtol=0, atol=1e-5)
    assert bool((to != 0).all())                    # the shift was seen
    _, (jsyms, _, _, jto) = _jax_stream((2, 4), "shift")
    np.testing.assert_array_equal(nn(syms), jsyms)
    np.testing.assert_allclose(nn(to), jto, rtol=0, atol=2e-3)


def test_planar_full_chain_on_mesh(jdevices):
    """test_parallel.py:132: TX -> dechirp -> the planar mesh demod -> the
    payloads; JAX's mesh gives the same symbols."""
    rng = np.random.RandomState(2)
    payloads = rng.randint(0, 256, (2, 31)).astype(np.uint8)
    tp = tparams(P7)
    from lora_phy_tpu_torch.ops import planar as tplanar

    re, im = tplanar.modulate_planar(tmodem.encode(tt(payloads)), tp)
    dr, di = tplanar.dechirp_planar(re, im, tp)
    syms, sync, _, _ = tps.demodulate_stream_planar(dr, di, tp, tmesh(2, 4))
    assert torch.equal(tmodem.decode(syms[..., 2:]), tt(payloads))
    assert bool((sync == P7.sync_word).all())
    jm = jmesh(2, 4)
    jre, jim = jplanar.modulate_planar(jmodem.encode(payloads), P7)
    jdr, jdi = jplanar.dechirp_planar(jre, jim, P7)
    jsyms = jps.demodulate_stream_planar(jput(jdr, jm), jput(jdi, jm), P7, jm)[0]
    np.testing.assert_array_equal(nn(syms), nn(jsyms))


def test_amplitude_normalisation_collective(jdevices):
    """test_parallel.py:610: the global per-channel pmax (x 2.5)."""
    syms = _check_stream((2, 4), "loud", (2, 4))
    assert syms.shape == (2, 64)


def test_comm_false_is_local_only():
    """comm=False (bench_scaling's stub) runs every shard alone: equal to
    the full program at one time shard; at four, shard 0 keeps its own
    estimate and the sync word."""
    _, dech = _make_stream(2, payload_len=31)
    re, im = (tt(a) for a in _planes(dech))
    tp = tparams(P7)
    full = tps.demodulate_stream_planar(re, im, tp, tmesh(2, 1))
    stub = tps.demodulate_stream_planar(re, im, tp, tmesh(2, 1), comm=False)
    for a, b in zip(full, stub):
        assert torch.equal(a, b)
    full = tps.demodulate_stream_planar(re, im, tp, tmesh(1, 4))
    stub = tps.demodulate_stream_planar(re, im, tp, tmesh(1, 4), comm=False)
    for a, b in zip(full[1:], stub[1:]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The sharded frame scan + block receiver
# ---------------------------------------------------------------------------

def _seam_streams(layout):
    """test_parallel.py:152's streams: a frame straddling every interior
    seam plus one inside shard 0, per channel."""
    n_ch, n_t = layout
    n_payload = 8
    frame_len = jstream.frame_overhead_samples(P7) + n_payload * P7.step
    block = 4096 if n_t == 4 else 4352
    total = n_t * block
    rng = np.random.RandomState(11)
    chans, placed = [], []
    for c in range(n_ch):
        s = np.zeros(total, np.complex64)
        rows = {}
        starts = [seam * block - frame_len // 2 + 17 * c for seam in range(1, n_t)]
        starts.append(100 + 50 * c)
        for off in starts:
            pl = rng.randint(0, 256, n_payload // 2).astype(np.uint8)
            iq = np.asarray(jstream.frame_modulate(jmodem.encode(pl), P7))
            s[off: off + iq.size] = iq
            rows[off] = pl
        chans.append(s)
        placed.append(rows)
    return _planes(np.stack(chans)), placed, n_payload


@functools.cache
def _jax_seams(layout):
    (re, im), _, n_payload = _seam_streams(layout)
    m = jmesh(*layout)
    return frame_rows(jps.receive_stream_block_planar(jput(re, m), jput(im, m), P7,
                                                      n_payload, m, max_frames=2))


@pytest.mark.parametrize("layout", [(2, 4), (1, 8)])
def test_time_sharded_frame_scan_across_seams(jdevices, layout):
    """test_parallel.py:152: frames straddling every seam are found once,
    at their global starts, as the single-device receiver finds them."""
    (re, im), placed, n_payload = _seam_streams(layout)
    tp = tparams(P7)
    blk = tps.receive_stream_block_planar(tt(re), tt(im), tp, n_payload,
                                          tmesh(*layout), max_frames=2)
    assert blk.found.shape == (layout[0], 2 * layout[1])
    ref = tsync.receive_block_planar(tt(re), tt(im), tp, n_payload,
                                     max_frames=layout[1] + 1)
    got = frame_rows(blk)
    want = frame_rows(ref)
    assert_same_frames(got, want)
    for c in range(layout[0]):
        assert {s for (cc, s) in got if cc == c} == set(placed[c])
    for (c, s), row in got.items():
        dec = tmodem.decode(torch.tensor(row["symbols"], dtype=torch.int32))
        np.testing.assert_array_equal(nn(dec), placed[c][s])
    if layout == (2, 4):
        assert_same_frames(got, _jax_seams(layout))


def test_time_sharded_frame_scan_rejects_end_truncated_frame(jdevices):
    """test_parallel.py:218: a frame cut by the END of the global stream is
    not reported (the last shard's halo is zero fill past the end)."""
    n_payload = 8
    frame_len = jstream.frame_overhead_samples(P7) + n_payload * P7.step
    total = 2 * 4096
    off = total - frame_len + frame_len // 3
    pl = np.arange(n_payload // 2, dtype=np.uint8)
    iq = np.asarray(jstream.frame_modulate(jmodem.encode(pl), P7))
    s = np.zeros((1, total), np.complex64)
    s[0, off:] = iq[: total - off]
    re, im = _planes(s)
    tp = tparams(P7)
    assert not bool(tsync.receive_block_planar(tt(re), tt(im), tp, n_payload,
                                               max_frames=2).found.any())
    blk = tps.receive_stream_block_planar(tt(re), tt(im), tp, n_payload,
                                          tmesh(1, 2), max_frames=2)
    assert not bool(blk.found.any())
    jm = jmesh(1, 2)
    jblk = jps.receive_stream_block_planar(jput(re, jm), jput(im, jm), P7, n_payload,
                                           jm, max_frames=2)
    assert not np.asarray(jblk.found).any()


def test_time_sharded_frame_scan_rejects_short_blocks():
    """test_parallel.py:254."""
    re = np.zeros((1, 8 * 512), np.float32)
    with pytest.raises(ValueError, match="shorter than one"):
        tps.receive_stream_block_planar(tt(re), tt(re), tparams(P7), 8, tmesh(1, 8))


def test_blind_sf_receive_on_mesh(jdevices):
    """test_parallel.py:264: frames of different SFs, one straddling the
    seam, found at their SF; rows equal JAX's mesh and the port's
    single-device blind receiver. An SF whose halo exceeds the block is
    skipped with a warning in both packages."""
    p9 = LoraParams(sf=9)
    block = 16384
    total = 2 * block
    n_pay = 8
    rng = np.random.RandomState(3)
    s = np.zeros((2, total), np.complex64)
    pl7 = rng.randint(0, 256, n_pay // 2).astype(np.uint8)
    iq7 = np.asarray(jstream.frame_modulate(jmodem.encode(pl7), P7))
    s[0, 700: 700 + iq7.size] = iq7
    pl9 = rng.randint(0, 256, n_pay // 2).astype(np.uint8)
    iq9 = np.asarray(jstream.frame_modulate(jmodem.encode(pl9), p9))
    off9 = block - iq9.size // 2
    s[1, off9: off9 + iq9.size] = iq9
    re, im = _planes(s)
    tp = tparams(P7)

    def key(rows):
        return [(r["sf"], r["index"], r["start"], int(r["sync"]),
                 tuple(int(v) for v in nn(r["symbols"]))) for r in rows]

    res = tps.receive_blind_stream_planar(tt(re), tt(im), tp, n_pay, tmesh(2, 2),
                                          sfs=(7, 8, 9), max_frames=2)
    rows = tsync.blind_frames(res)
    assert [(r["sf"], r["index"], r["start"]) for r in rows] == [
        (7, (0,), 700), (9, (1,), off9)]
    np.testing.assert_array_equal(nn(tmodem.decode(rows[0]["symbols"])), pl7)
    np.testing.assert_array_equal(nn(tmodem.decode(rows[1]["symbols"])), pl9)
    ref = tsync.blind_frames(tsync.receive_blind_planar(tt(re), tt(im), tp, n_pay,
                                                        sfs=(7, 8, 9), max_frames=2))
    assert key(rows) == key(ref)
    jm = jmesh(2, 2)
    jrows = jsync.blind_frames(jps.receive_blind_stream_planar(
        jput(re, jm), jput(im, jm), P7, n_pay, jm, sfs=(7, 8, 9), max_frames=2))
    assert key(rows) == key(jrows)

    # SF12's frame + margin (~50 x 4096 samples) does not fit a block
    for fn, x, mesh in ((tps.receive_blind_stream_planar, tt(re), tmesh(2, 2)),
                        (jps.receive_blind_stream_planar, jput(re, jm), jm)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out = fn(x, x, P7 if fn is jps.receive_blind_stream_planar else tp,
                     n_pay, mesh, sfs=(12,), max_frames=2)
        assert out == {} and any("skipped SF12" in str(x.message) for x in w)


@functools.cache
def _soft_case():
    cfg = jcoded.CodedConfig(sf=7, cr=4, crc=True)
    pls = [b"soft mesh %d" % c for c in range(4)]
    nsym = jcoded.payload_symbol_count(len(pls[0]), cfg)
    n_pay = 8 + nsym
    frame_len = jstream.frame_overhead_samples(P7) + n_pay * P7.step
    block = 8192
    total = 2 * block
    rng = np.random.RandomState(7)
    xr = np.zeros((4, total), np.float32)
    xi = np.zeros((4, total), np.float32)
    offs = []
    for c in range(4):
        iq = np.asarray(jstream.frame_encode(np.frombuffer(pls[c], np.uint8), cfg, P7))
        off = block - frame_len // 2 + 31 * c
        xr[c, off: off + iq.size] = iq.real
        xi[c, off: off + iq.size] = iq.imag
        offs.append(off)
    xr += rng.randn(4, total).astype(np.float32) * 0.18
    xi += rng.randn(4, total).astype(np.float32) * 0.18
    jm = jmesh(4, 2)
    jblk, jspec = jps.receive_stream_block_planar(
        jput(xr, jm), jput(xi, jm), P7, n_pay, jm, max_frames=2,
        min_power_db=-30.0, with_spectra=True)
    return xr, xi, pls, offs, n_pay, nsym, frame_rows(jblk, jspec)


def test_soft_decode_on_mesh_spectra(jdevices):
    """test_parallel.py:307: seam-straddling coded frames in noise
    soft-decode from the mesh's spectra; the spectra equal the port's
    single-device receiver's and JAX's mesh within 2e-5 of the peak (the
    JAX test holds its mesh bit-equal to its single device: the port's
    CPU GEMMs round a row by its place in the batch, ~2e-7 of the peak)."""
    xr, xi, pls, offs, n_pay, nsym, jrows = _soft_case()
    cfg = tcoded.CodedConfig(sf=7, cr=4, crc=True)
    tp = tparams(P7)
    blk, spec = tps.receive_stream_block_planar(
        tt(xr), tt(xi), tp, n_pay, tmesh(4, 2), max_frames=2, min_power_db=-30.0,
        with_spectra=True)
    rows = frame_rows(blk, spec)
    assert sorted(rows) == [(c, offs[c]) for c in range(4)]
    for (c, _), row in rows.items():
        np.testing.assert_array_equal(np.argmax(row["spectra"], axis=-1),
                                      np.asarray(row["symbols"]))
        nb, cr, _, hok = tcoded.decode_header(torch.tensor(row["symbols"][:8]), 7)
        assert hok and nb == len(pls[c]) and cr == 4
        pay, crc_ok, _ = tsoft.decode_payload_soft(
            torch.from_numpy(row["spectra"][8:8 + nsym]), nb, cfg)
        assert bool(crc_ok) and nn(pay).tobytes() == pls[c]
    ref, ref_spec = tsync.receive_block_planar(tt(xr), tt(xi), tp, n_pay, max_frames=4,
                                               min_power_db=-30.0, with_spectra=True)
    ref_rows = frame_rows(ref, ref_spec)
    assert_same_frames(rows, {k: ref_rows[k] for k in rows})
    assert_same_frames(rows, jrows)


def test_robust_receive_on_mesh(jdevices):
    """test_parallel.py:457: pre_acc=3 over a two-ray 0.95@3 channel with
    seam-straddling frames: decoded, equal to the port's single-device
    robust receiver (frame-matched) and to JAX's mesh."""
    block = 8192
    total = 2 * block
    rng = np.random.RandomState(5)
    pls = (np.arange(6, dtype=np.uint8)[None, :] + np.arange(4, dtype=np.uint8)[:, None])
    syms = jmodem.encode(pls)
    n_pay = syms.shape[-1]
    fr, fi = jstream.frame_modulate_planar(np.asarray(syms, np.int32), P7)
    fl = fr.shape[-1]
    yr = np.zeros((4, total), np.float32)
    yi = np.zeros((4, total), np.float32)
    offs = []
    for c in range(4):
        off = block - fl // 2 + 17 * c
        yr[c, off: off + fl] = np.asarray(fr[c])
        yi[c, off: off + fl] = np.asarray(fi[c])
        offs.append(off)
    taps_re = np.zeros(4, np.float32)
    taps_re[0], taps_re[3] = 1.0, 0.95
    yr, yi = jimpair.apply_multipath_planar(yr, yi, taps_re, np.zeros(4, np.float32))
    yr = np.asarray(yr) + rng.randn(4, total).astype(np.float32) * 0.05
    yi = np.asarray(yi) + rng.randn(4, total).astype(np.float32) * 0.05
    tp = tparams(P7)
    blk = tps.receive_stream_block_planar(tt(yr), tt(yi), tp, n_pay, tmesh(4, 2),
                                          max_frames=2, min_power_db=-30.0, pre_acc=3)
    rows = frame_rows(blk)
    ref = frame_rows(tsync.receive_block_planar(tt(yr), tt(yi), tp, n_pay, max_frames=4,
                                                min_power_db=-30.0, pre_acc=3))
    for c in range(4):
        ks = [s for (cc, s) in rows if cc == c and abs(s - offs[c]) <= P7.step]
        assert ks, (c, offs[c])
        dec = tmodem.decode(torch.tensor(rows[(c, ks[0])]["symbols"]))
        np.testing.assert_array_equal(nn(dec), pls[c])
        assert rows[(c, ks[0])]["symbols"] == ref[(c, ks[0])]["symbols"]
    jm = jmesh(4, 2)
    jrows = frame_rows(jps.receive_stream_block_planar(
        jput(yr, jm), jput(yi, jm), P7, n_pay, jm, max_frames=2, min_power_db=-30.0,
        pre_acc=3))
    assert_same_frames(rows, jrows)


def _adaptive_stream(payloads, offs, total):
    s = np.zeros((len(payloads), total), np.complex64)
    for c in range(len(payloads)):
        for b, off in zip(payloads[c], offs[c]):
            iq = np.asarray(jstream.frame_encode(np.frombuffer(b, np.uint8),
                                                 jcoded.CodedConfig(sf=7, cr=2), P7))
            s[c, off: off + iq.size] = iq
    return _planes(s)


def _adaptive_key(res):
    return [(r["channel"], r["start"], r["payload"],
             {k: v for k, v in r["info"].items()}) for r in res]


def test_adaptive_receive_on_mesh(jdevices):
    """test_parallel.py:517: header-driven frames of different lengths (one
    straddling the seam): two sharded passes; every row and info field
    equal to JAX's."""
    block = 16384
    payloads = [[b"short", b"a much longer frame payload!!"], [b"mesh adaptive", b"x"]]
    offs = [[300, block - 700], [900, block + 2000]]
    re, im = _adaptive_stream(payloads, offs, 2 * block)
    res = tps.receive_adaptive_stream_planar(tt(re), tt(im), tparams(P7), tmesh(2, 2),
                                             max_frames=2)
    expect = sorted((c, off, b) for c in range(2) for b, off in zip(payloads[c], offs[c]))
    assert [(r["channel"], r["start"], r["payload"]) for r in res] == expect
    assert all(r["info"]["header_ok"] and r["info"]["crc_ok"] for r in res)
    jm = jmesh(2, 2)
    jres = jps.receive_adaptive_stream_planar(jput(re, jm), jput(im, jm), P7, jm,
                                              max_frames=2)
    assert _adaptive_key(res) == _adaptive_key(jres)


def test_adaptive_mesh_defers_frame_longer_than_block(jdevices):
    """test_parallel.py:664: a header whose length cannot fit a shard block
    gets an error row; the other frame still decodes — as in JAX."""
    block = 16384
    payloads = [[b"fits fine"], [bytes(range(120))]]
    re, im = _adaptive_stream(payloads, [[400], [200]], 2 * block)
    res = tps.receive_adaptive_stream_planar(tt(re), tt(im), tparams(P7), tmesh(2, 2),
                                             max_frames=2)
    by_channel = {r["channel"]: r for r in res}
    assert by_channel[0]["payload"] == b"fits fine" and by_channel[0]["info"]["crc_ok"]
    assert by_channel[1]["payload"] is None
    assert "time-shard block" in by_channel[1]["info"]["error"]
    jm = jmesh(2, 2)
    jres = jps.receive_adaptive_stream_planar(jput(re, jm), jput(im, jm), P7, jm,
                                              max_frames=2)
    assert _adaptive_key(res) == _adaptive_key(jres)


# ---------------------------------------------------------------------------
# MeshStreamDemodulator: checkpoint / resume, across the packages too
# ---------------------------------------------------------------------------

B_CKPT, N_BLOCKS, N_PAY_CKPT = 16384, 3, 8


@functools.cache
def _ckpt_stream():
    """test_parallel.py:378's stream: a frame inside every fed block and
    one straddling every fed-block boundary, two channels."""
    frame_len = jstream.frame_overhead_samples(P7) + N_PAY_CKPT * P7.step
    total = N_BLOCKS * B_CKPT
    rng = np.random.RandomState(21)
    xr = np.zeros((2, total), np.float32)
    xi = np.zeros((2, total), np.float32)
    placed = {0: {}, 1: {}}
    for c in range(2):
        starts = [4000 + 37 * c + b * B_CKPT for b in range(N_BLOCKS)]
        starts += [b * B_CKPT - frame_len // 2 + 23 * c for b in range(1, N_BLOCKS)]
        for off in starts:
            pl = rng.randint(0, 256, N_PAY_CKPT // 2).astype(np.uint8)
            fr, fi = jstream.frame_modulate_planar(np.asarray(jmodem.encode(pl), np.int32), P7)
            xr[c, off: off + frame_len] = np.asarray(fr)
            xi[c, off: off + frame_len] = np.asarray(fi)
            placed[c][off] = pl
    return xr, xi, placed


def _blocks(b):
    xr, xi, _ = _ckpt_stream()
    return xr[:, b * B_CKPT:(b + 1) * B_CKPT], xi[:, b * B_CKPT:(b + 1) * B_CKPT]


@functools.cache
def _jax_ckpt_run(tmp_dir):
    """JAX's uninterrupted run at (2, 4): its frames, and its carry saved
    after block 1."""
    jm = jmesh(2, 4)
    rx = jps.MeshStreamDemodulator(P7, N_PAY_CKPT, jm, max_frames=2)
    state, out = rx.init_state(2), []
    for b in range(N_BLOCKS):
        if b == 1 + 1:
            jps.save_mesh_state(state, f"{tmp_dir}/jax_after1.npz")
        state, frames = rx.process(state, *_blocks(b))
        out.append(frames)
    return out, state


def _port_run(save_after=None, path=None, state=None, first=0):
    rx = tps.MeshStreamDemodulator(tparams(P7), N_PAY_CKPT, tmesh(2, 4), max_frames=2)
    state = rx.init_state(2) if state is None else state
    out = []
    for b in range(first, N_BLOCKS):
        if save_after is not None and b == save_after:
            tps.save_mesh_state(state, path)
            rx = tps.MeshStreamDemodulator(tparams(P7), N_PAY_CKPT, tmesh(2, 4),
                                           max_frames=2)
            state = tps.load_mesh_state(path, device="cpu")
        state, frames = rx.process(state, *(tt(a) for a in _blocks(b)))
        out.append(frames)
    return out, state


def same_rows(port_frames, jax_frames, exact_floats=True):
    assert [(r["channel"], r["start"]) for r in port_frames] == \
        [(r["channel"], r["start"]) for r in jax_frames]
    for a, b in zip(port_frames, jax_frames):
        np.testing.assert_array_equal(nn(a["symbols"]), nn(b["symbols"]))
        assert a["sync"] == b["sync"] and a["cfo_bins"] == b["cfo_bins"]
        if exact_floats:
            for key in ("cfo", "snr_db", "sro_ppm"):
                assert a[key] == b[key], key
        else:
            assert abs(a["cfo"] - b["cfo"]) <= 1e-5
            assert abs(a["snr_db"] - b["snr_db"]) <= 1e-2
            assert abs(a["sro_ppm"] - b["sro_ppm"]) <= 0.05


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh_ckpt"))


def test_mesh_stream_checkpoint_resume(jdevices, tmp_path, ckpt_dir):
    """test_parallel.py:378: stop after block 1, resume in a fresh
    demodulator: the same frames, bit-exact, including the one straddling
    the checkpoint boundary; every placed frame once; JAX's frames."""
    cont, st_c = _port_run()
    resumed, st_r = _port_run(save_after=1, path=tmp_path / "mesh.ckpt")
    _, _, placed = _ckpt_stream()
    flat = [r for blk in cont for r in blk]
    assert {(r["channel"], r["start"]) for r in flat} == \
        {(c, off) for c in placed for off in placed[c]}
    for r in flat:
        np.testing.assert_array_equal(nn(tmodem.decode(r["symbols"])),
                                      placed[r["channel"]][r["start"]])
    same_rows([r for blk in resumed for r in blk], flat)
    assert st_c.consumed == st_r.consumed
    assert st_c.n_frames == st_r.n_frames == len(flat)
    np.testing.assert_array_equal(st_c.emitted_start, st_r.emitted_start)
    assert torch.equal(st_c.tail_re, st_r.tail_re)
    jax_out, jst = _jax_ckpt_run(ckpt_dir)
    same_rows(flat, [r for blk in jax_out for r in blk], exact_floats=False)
    assert st_c.consumed == jst.consumed and st_c.n_frames == jst.n_frames
    np.testing.assert_array_equal(st_c.emitted_start, jst.emitted_start)
    np.testing.assert_array_equal(nn(st_c.tail_re), jst.tail_re)


def test_mesh_checkpoint_crosses_packages(jdevices, tmp_path, ckpt_dir):
    """A carry written by JAX's MeshStreamDemodulator after block 1 resumes
    in the port's, and one written by the port's resumes in JAX's: block
    2's frames equal the uninterrupted runs'. The files hold the same
    keys and dtypes."""
    jax_out, _ = _jax_ckpt_run(ckpt_dir)
    state = tps.load_mesh_state(f"{ckpt_dir}/jax_after1.npz", device="cpu")
    out, _ = _port_run(state=state, first=2)
    same_rows(out[0], jax_out[2], exact_floats=False)

    cont, _ = _port_run()
    path = tmp_path / "port_after1.npz"
    rx = tps.MeshStreamDemodulator(tparams(P7), N_PAY_CKPT, tmesh(2, 4), max_frames=2)
    st = rx.init_state(2)
    for b in range(2):
        st, _ = rx.process(st, *(tt(a) for a in _blocks(b)))
    tps.save_mesh_state(st, path)
    with np.load(path) as zp, np.load(f"{ckpt_dir}/jax_after1.npz") as zj:
        assert sorted(zp.files) == sorted(zj.files)
        assert all(zp[k].dtype == zj[k].dtype for k in zj.files)
    jrx = jps.MeshStreamDemodulator(P7, N_PAY_CKPT, jmesh(2, 4), max_frames=2)
    _, frames = jrx.process(jps.load_mesh_state(path), *_blocks(2))
    same_rows(cont[2], frames, exact_floats=False)


# ---------------------------------------------------------------------------
# bench_scaling
# ---------------------------------------------------------------------------

def test_scaling_harness_smoke(capsys):
    """test_parallel.py:635: bench_scaling's record on CPU shards (their
    efficiency reflects shared host cores, not hardware)."""
    from lora_phy_tpu.parallel.multihost import scaling_report as jreport
    from lora_phy_tpu_torch.parallel.multihost import scaling_report
    from lora_phy_tpu_torch.runners import bench_scaling

    assert bench_scaling.main(["--devices=1,2", "--frames=4", "--iters=2",
                               "--repeats=3", "--device=cpu"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["mode"] == "weak" and doc["host_cores"] >= 1
    assert doc["platform"] == "cpu" and doc["virtual_mesh"]
    rows = doc["rows"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["mesh"] for r in rows] == ["1x1", "1x2"]
    assert all(r["samples_per_s"] > 0 for r in rows)
    assert all("collective_ms" in r and "t_nocomm_ms" in r for r in rows)
    assert rows[0]["efficiency"] == 1.0
    assert scaling_report(1e6, 3.6e6, 4) == jreport(1e6, 3.6e6, 4)
    assert bench_scaling.main(["--mode=neither", "--device=cpu"]) == 1
