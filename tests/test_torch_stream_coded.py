"""Port parity: the complex / serial half of lora_phy_tpu_torch.models.stream
(frame_modulate, frame_encode, frame_sync, first_candidate,
frame_demodulate, StreamDemodulator, save_state / load_state,
frame_decode_adaptive, AdaptiveStreamDemodulator) and the complex
chirp API (modulate_symbols, base_downchirp) against the JAX package.

TX IQ is bit-equal. Every decision is bit-equal: frame starts, integer
CFO, symbols, sync word, header fields, payload bytes, crc_ok and
fec_errors. Floats carry stated tolerances: residual CFO within 1e-6
bins; spectra within 2e-5 of the frame's peak |X|^2 (the integer-CFO
derotation's cos/sin and the dechirp's complex products round
differently from XLA's); soft_margin within 1e-4 relative. Noise is
numpy-seeded complex AWGN, added to the same IQ for both packages."""

import numpy as np
import pytest
import torch

from _torch_util import cuda_device, nn, tparams, tt
from lora_phy_tpu.models import coded as jcoded
from lora_phy_tpu.models import stream as jstream
from lora_phy_tpu.ops import chirp as jchirp
from lora_phy_tpu.ops.impair import apply_cfo_continuous
from lora_phy_tpu.utils.params import Bandwidth, LoraParams
from lora_phy_tpu_torch.models import coded as tcoded
from lora_phy_tpu_torch.models import stream as tstream
from lora_phy_tpu_torch.ops import chirp as tchirp

CFO_ATOL = 1e-6
SPECTRA_TOL = 2e-5          # of the frame's peak |X|^2
MARGIN_RTOL = 1e-4

P7 = LoraParams(sf=7)


def _awgn(x, snr_db, seed):
    """``x`` plus numpy-seeded complex AWGN at ``snr_db`` per sample
    (unit-power chirps), complex64."""
    rng = np.random.RandomState(seed)
    sigma = np.sqrt(10.0 ** (-snr_db / 10.0) / 2.0)
    noise = sigma * (rng.randn(x.size) + 1j * rng.randn(x.size))
    return (x + noise).astype(np.complex64)


def _coded_stream(p, specs, seed, lead=313, ldro=False):
    """A stream of JAX ``frame_encode`` frames: ``specs`` is a list of
    (payload length, cr, crc, gap samples after the frame). Returns the
    complex64 stream and the true (start, payload bytes, cr, crc)."""
    rng = np.random.RandomState(seed)
    parts, truth, pos = [np.zeros(lead, np.complex64)], [], lead
    for length, cr, crc, gap in specs:
        payload = rng.randint(0, 256, length).astype(np.uint8)
        cfg = jcoded.CodedConfig(sf=p.sf, cr=cr, crc=crc, ldro=ldro)
        iq = np.asarray(jstream.frame_encode(payload, cfg, p))
        truth.append((pos, payload.tobytes(), cr, crc))
        parts += [iq, np.zeros(gap, np.complex64)]
        pos += iq.size + gap
    parts.append(np.zeros(4 * p.step, np.complex64))
    return np.concatenate(parts), truth


def _jax_frames(demod, sig, block):
    st, got = demod.init_state(), []
    for i in range(0, sig.size, block):
        st, out = demod.process(st, sig[i:i + block])
        got.extend(out)
    return st, got


def _torch_frames(demod, sig, block, st=None, start=0):
    st, got = st or demod.init_state(), []
    for i in range(start, sig.size, block):
        st, out = demod.process(st, tt(sig[i:i + block]))
        got.extend(out)
    return st, got


def _assert_same_adaptive(got, ref):
    """Equal (start, payload, info) lists; soft_margin within MARGIN_RTOL."""
    assert len(got) == len(ref), ([g[0] for g in got], [r[0] for r in ref])
    for (s, pay, info), (rs, rpay, rinfo) in zip(got, ref):
        assert (s, pay) == (rs, rpay)
        info, rinfo = dict(info), dict(rinfo)
        if "soft_margin" in rinfo:
            m, rm = info.pop("soft_margin"), rinfo.pop("soft_margin")
            assert abs(m - rm) <= MARGIN_RTOL * abs(rm), (m, rm)
        assert info == rinfo


# ---------------------------------------------------------------------------
# TX: bit-equal IQ
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,preamble_len,amplitude", [
    (LoraParams(sf=7), 8, 1.0),
    (LoraParams(sf=7, osr=2, continuous_chirp=True), 8, 1.0),
    (LoraParams(sf=7, bw=Bandwidth.BW_250), 10, 0.5),
    (LoraParams(sf=9, osr=2), 6, 1.0),
], ids=["sf7", "sf7_osr2_cont", "sf7_bw250", "sf9_osr2"])
@pytest.mark.parametrize("carry", [True, False], ids=["carry", "nocarry"])
def test_frame_modulate_bit_equal(p, preamble_len, amplitude, carry):
    syms = np.random.RandomState(p.sf).randint(0, p.n, (2, 9)).astype(np.int32)
    ref = nn(jstream.frame_modulate(syms, p, preamble_len, amplitude,
                                    symbol_phase_carry=carry))
    got = tstream.frame_modulate(tt(syms), tparams(p), preamble_len, amplitude,
                                 symbol_phase_carry=carry)
    assert got.dtype == torch.complex64 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(nn(got), ref)
    if carry:
        planes = tstream.frame_modulate_planar(tt(syms), tparams(p), preamble_len, amplitude)
        assert torch.equal(torch.complex(*planes), got)


@pytest.mark.parametrize("carry", [True, False], ids=["carry", "nocarry"])
def test_modulate_symbols_and_base_downchirp_vs_jax(carry):
    for p in (LoraParams(sf=7), LoraParams(sf=9, osr=2), LoraParams(sf=7, bw=Bandwidth.BW_500)):
        syms = np.random.RandomState(p.sf).randint(0, 2 * p.n, (3, 5)).astype(np.int32)
        ref = nn(jchirp.modulate_symbols(syms, p.sf, p.osr, p.scale, 0.7, 0x34,
                                         p.continuous_chirp, carry))
        got = tchirp.modulate_symbols(tt(syms), p.sf, p.osr, p.scale, 0.7, 0x34,
                                      p.continuous_chirp, carry)
        assert got.dtype == torch.complex64
        np.testing.assert_array_equal(nn(got), ref)
        down = tchirp.base_downchirp(p.sf, p.scale, p.osr, device="cpu")
        np.testing.assert_array_equal(nn(down), nn(jchirp.base_downchirp(p.sf, p.scale, p.osr)))


@pytest.mark.parametrize("cr", [1, 2, 3, 4])
@pytest.mark.parametrize("crc,ldro", [(True, False), (False, False), (True, True)],
                         ids=["crc", "nocrc", "crc_ldro"])
def test_frame_encode_bit_equal(cr, crc, ldro):
    p = LoraParams(sf=8)
    payload = np.random.RandomState(cr).randint(0, 256, 5 + 7 * cr).astype(np.uint8)
    ref = nn(jstream.frame_encode(payload, jcoded.CodedConfig(sf=8, cr=cr, crc=crc, ldro=ldro), p))
    got = tstream.frame_encode(tt(payload), tcoded.CodedConfig(sf=8, cr=cr, crc=crc, ldro=ldro),
                               tparams(p))
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(nn(got), ref)


# ---------------------------------------------------------------------------
# RX: frame_sync / frame_demodulate
# ---------------------------------------------------------------------------

def _one_frame(p, offset, cfo=0.0, snr_db=None, cr=2, tail=3, seed=0):
    payload = np.random.RandomState(seed).randint(0, 256, 10).astype(np.uint8)
    cfg = jcoded.CodedConfig(sf=p.sf, cr=cr)
    syms = nn(jcoded.encode_payload(payload, cfg)).astype(np.int32)
    iq = nn(jstream.frame_modulate(syms, p))
    sig = np.concatenate([np.zeros(offset, np.complex64), iq,
                          np.zeros(tail * p.step, np.complex64)])
    if cfo:
        sig = np.asarray(apply_cfo_continuous(sig, cfo, p.n, p.osr)).astype(np.complex64)
    if snr_db is not None:
        sig = _awgn(sig, snr_db, seed)
    return sig, syms, payload, cfg


_SYNC_CASES = {
    "off0": (P7, 0, 0.0, None), "off5": (P7, 5, 0.0, None),
    "off137": (P7, 137, 0.0, None), "off300": (P7, 300, 0.0, None),
    "cfo2": (P7, 777, 2.0, None), "cfo-1.3_noise": (P7, 211, -1.3, 5.0),
    "sf8_cfo3_noise": (LoraParams(sf=8), 3 * 256, 3.0, 20.0),
    "bw250": (LoraParams(sf=7, bw=Bandwidth.BW_250), 300, 0.0, None),
}


@pytest.mark.parametrize("case", sorted(_SYNC_CASES))
def test_frame_sync_and_demodulate_vs_jax(case):
    """frame_sync's result and frame_demodulate's symbols, sync word,
    residual CFO and (return_spectra) spectra against JAX's."""
    p, offset, cfo, snr = _SYNC_CASES[case]
    tp = tparams(p)
    sig, syms, _, _ = _one_frame(p, offset, cfo, snr)
    ref = jstream.frame_sync(sig, p)
    got = tstream.frame_sync(tt(sig), tp)
    assert isinstance(got, tstream.FrameSyncResult)
    assert tuple(got) == tuple(ref) and got.found
    nsym = syms.shape[-1]
    jout, jres, jmag2 = jstream.frame_demodulate(sig, p, nsym, return_spectra=True)
    out, res, mag2 = tstream.frame_demodulate(tt(sig), tp, nsym, return_spectra=True)
    assert tuple(res) == tuple(jres)
    assert out.symbols.dtype == torch.int32
    np.testing.assert_array_equal(nn(out.symbols), nn(jout.symbols).astype(np.int32))
    assert int(out.sync_word) == int(jout.sync_word)
    assert abs(float(out.cfo) - float(jout.cfo)) <= CFO_ATOL
    jmag2 = nn(jmag2)
    assert tuple(mag2.shape) == jmag2.shape == (nsym, p.n)
    assert np.max(np.abs(nn(mag2) - jmag2)) <= SPECTRA_TOL * jmag2.max()
    if (snr is None or snr >= 20.0) and p.scale == 1.0:
        # (at BW250 the demodulated bins alias by the chirp slope)
        np.testing.assert_array_equal(nn(out.symbols), syms)


def test_frame_demodulate_options_vs_jax():
    """tx_phase_step=0.0, a precomputed sync_result, a payload running
    past the stream end, and a stream too short to hold a frame."""
    sig, syms, _, _ = _one_frame(P7, 97, cfo=1.0)
    tp = tparams(P7)
    nsym = syms.shape[-1]
    jout, jres = jstream.frame_demodulate(sig, P7, nsym, tx_phase_step=0.0)
    out, res = tstream.frame_demodulate(tt(sig), tp, nsym, tx_phase_step=0.0)
    np.testing.assert_array_equal(nn(out.symbols), nn(jout.symbols).astype(np.int32))
    assert abs(float(out.cfo) - float(jout.cfo)) <= CFO_ATOL
    pre = tstream.frame_sync(tt(sig), tp)
    again, _ = tstream.frame_demodulate(tt(sig), tp, nsym, sync_result=pre)
    assert torch.equal(again.symbols, tstream.frame_demodulate(tt(sig), tp, nsym)[0].symbols)
    short = sig[: 97 + tstream.frame_overhead_samples(tp) + 4 * P7.step]
    for mine, theirs in ((tstream.frame_demodulate(tt(short), tp, nsym),
                          jstream.frame_demodulate(short, P7, nsym)),):
        assert mine[0] is None and theirs[0] is None
        assert tuple(mine[1]) == tuple(theirs[1])
    tiny = sig[: 12 * P7.step]
    assert tuple(tstream.frame_sync(tt(tiny), tp)) == tuple(jstream.frame_sync(tiny, P7))
    silent = np.zeros(40 * P7.step, np.complex64)
    assert tuple(tstream.frame_sync(tt(silent), tp, min_power_db=-30.0)) == \
        tuple(jstream.frame_sync(silent, P7, min_power_db=-30.0))


def test_first_candidate_vs_jax():
    from lora_phy_tpu.models import sync as jsync
    from lora_phy_tpu_torch.models import sync as tsync

    sig, _, _, _ = _one_frame(P7, 300)
    jscan = jsync.frame_sync_scan_planar(np.ascontiguousarray(sig.real),
                                         np.ascontiguousarray(sig.imag), P7)
    tscan = tsync.frame_sync_scan_planar(tt(sig.real.copy()), tt(sig.imag.copy()), tparams(P7))
    assert tstream.first_candidate(tscan) == jstream.first_candidate(jscan) is not None
    empty = tsync.frame_sync_scan_planar(torch.zeros(4096), torch.zeros(4096), tparams(P7),
                                         min_power_db=-30.0)
    assert tstream.first_candidate(empty) is None


# ---------------------------------------------------------------------------
# Serial receivers
# ---------------------------------------------------------------------------

def test_stream_demodulator_vs_jax():
    """Two frames across unaligned blocks: the same absolute starts and
    symbols as JAX's, and the same carry."""
    cfg = jcoded.CodedConfig(sf=7, cr=1)
    rng = np.random.RandomState(9)
    pay = [rng.randint(0, 256, 10).astype(np.uint8) for _ in range(2)]
    syms = [nn(jcoded.encode_payload(x, cfg)) for x in pay]
    iqs = [nn(jstream.frame_modulate(s, P7)) for s in syms]
    sig = np.concatenate([np.zeros(211, np.complex64), iqs[0], np.zeros(3 * 128, np.complex64),
                          iqs[1], np.zeros(256, np.complex64)])
    nsym = syms[0].shape[-1]
    jd = jstream.StreamDemodulator(P7, nsym)
    td = tstream.StreamDemodulator(tparams(P7), nsym, device="cpu")
    block = 2 * td.frame_len + 77
    jst, ref = _jax_frames(jd, sig, block)
    tst, got = _torch_frames(td, sig, block)
    assert len(got) == len(ref) == 2
    for (s, out), (rs, rout), expect in zip(got, ref, syms):
        assert s == rs
        np.testing.assert_array_equal(nn(out.symbols), nn(rout.symbols).astype(np.int32))
        np.testing.assert_array_equal(nn(out.symbols), expect.astype(np.int32))
    assert tst.consumed == jst.consumed
    np.testing.assert_array_equal(nn(tst.tail), nn(jst.tail))


_ADAPTIVE_SPECS = [(5, 1, True, 0), (40, 4, False, 3 * 128), (1, 2, True, 128 + 5),
                   (23, 3, True, 2 * 128)]


@pytest.fixture(scope="module")
def adaptive_streams():
    """SF7 streams of four frames of different lengths, CR and CRC modes —
    clean, at 0 dB and at -8.5 dB per sample (where frames fail: bad
    headers, CRC failures) — and JAX's AdaptiveStreamDemodulator frame
    lists over unaligned blocks (hard and soft)."""
    sig, truth = _coded_stream(P7, _ADAPTIVE_SPECS, seed=3)
    streams = {"clean": sig, "noisy": _awgn(sig, 0.0, seed=3),
               "low_snr": _awgn(sig, -8.5, seed=4)}
    ref = {}
    for name, s in streams.items():
        for soft in (False, True):
            ref[name, soft] = _jax_frames(jstream.AdaptiveStreamDemodulator(P7, soft=soft),
                                          s, 5003)
    return streams, truth, ref


@pytest.mark.parametrize("name", ["clean", "noisy", "low_snr"])
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_adaptive_stream_demodulator_vs_jax(adaptive_streams, name, soft):
    streams, truth, ref = adaptive_streams
    demod = tstream.AdaptiveStreamDemodulator(tparams(P7), soft=soft, device="cpu")
    tst, got = _torch_frames(demod, streams[name], 5003)
    jst, jgot = ref[name, soft]
    _assert_same_adaptive(got, jgot)
    assert tst.consumed == jst.consumed
    np.testing.assert_array_equal(nn(tst.tail), nn(jst.tail))
    if name != "low_snr":
        assert [(g[0], g[1], g[2]["cr"], g[2]["crc"]) for g in got] == truth
        assert all(g[2]["crc_ok"] for g in got)


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("case", ["clean_cfo", "noisy", "ldro_sf8"])
def test_frame_decode_adaptive_vs_jax(case, soft):
    """One self-describing frame: (payload, info, consumed) as JAX's,
    under an integer CFO, under noise and with LDRO."""
    if case == "ldro_sf8":
        p, ldro = LoraParams(sf=8), True
        sig, truth = _coded_stream(p, [(30, 2, True, 0)], seed=4, ldro=True)
    else:
        p, ldro = P7, False
        sig, truth = _coded_stream(p, [(22, 4, True, 0)], seed=5)
        if case == "clean_cfo":
            sig = np.asarray(apply_cfo_continuous(sig, -2.0, p.n, p.osr)).astype(np.complex64)
        else:
            sig = _awgn(sig, -3.0, seed=5)
    ref = jstream.frame_decode_adaptive(sig, p, soft=soft, ldro=ldro)
    got = tstream.frame_decode_adaptive(tt(sig), tparams(p), soft=soft, ldro=ldro)
    _assert_same_adaptive([(got[2], got[0], got[1])], [(ref[2], ref[0], ref[1])])
    assert got[0] == truth[0][1] and got[1]["start"] == truth[0][0]


def test_adaptive_bad_header_and_silence_vs_jax():
    """A frame whose header symbols are replaced by noise is skipped past
    its sync point as in JAX; silence finds nothing."""
    sig, _ = _coded_stream(P7, [(12, 1, True, 0)], seed=6)
    hdr0 = 313 + tstream.frame_overhead_samples(tparams(P7))
    bad = sig.copy()
    bad[hdr0: hdr0 + 8 * P7.step] = _awgn(np.zeros(8 * P7.step, np.complex64), 0.0, 6)
    ref = jstream.frame_decode_adaptive(bad, P7)
    got = tstream.frame_decode_adaptive(tt(bad), tparams(P7))
    assert (got[0], got[1], got[2]) == (ref[0], ref[1], ref[2])
    silent = np.zeros(30 * P7.step, np.complex64)
    assert tstream.frame_decode_adaptive(tt(silent), tparams(P7), min_power_db=-30.0) == \
        jstream.frame_decode_adaptive(silent, P7, min_power_db=-30.0)


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_state_resume_across_packages(tmp_path, first, adaptive_streams):
    """A carry saved by one package after the first blocks resumes in the
    other and reports the remaining frames as an uninterrupted run does;
    the file is written to exactly the path given."""
    streams, truth, ref = adaptive_streams
    sig = streams["clean"]
    block, split = 5003, 2 * 5003
    path = tmp_path / "carry.state"
    jd = jstream.AdaptiveStreamDemodulator(P7)
    td = tstream.AdaptiveStreamDemodulator(tparams(P7), device="cpu")
    if first == "jax":
        st, head = _jax_frames(jd, sig[:split], block)
        jstream.save_state(st, path)
        st2 = tstream.load_state(path, device="cpu")
        assert st2.tail.dtype == torch.complex64 and st2.consumed == st.consumed
        _, rest = _torch_frames(td, sig, block, st=st2, start=split)
    else:
        st, head = _torch_frames(td, sig[:split], block)
        tstream.save_state(st, path)
        st2 = jstream.load_state(path)
        np.testing.assert_array_equal(nn(st2.tail), nn(st.tail))
        _, rest = _jax_frames_from(jd, st2, sig, block, split)
    assert path.exists() and not (tmp_path / "carry.state.npz").exists()
    got = head + rest
    assert [(g[0], g[1]) for g in got] == [(g[0], g[1]) for g in ref["clean", False][1]]


def _jax_frames_from(demod, st, sig, block, start):
    got = []
    for i in range(start, sig.size, block):
        st, out = demod.process(st, sig[i:i + block])
        got.extend(out)
    return st, got


def test_stream_entry_points_need_a_device(monkeypatch, tmp_path):
    """Entry points that make tensors from nothing or from arrays go to
    the first CUDA card, and with no card they raise."""
    path = tmp_path / "s.npz"
    tstream.save_state(tstream.StreamState(torch.zeros(3, dtype=torch.complex64), 5), path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tp, cfg = tparams(P7), tcoded.CodedConfig()
    for call in (lambda: tstream.load_state(path),
                 lambda: tstream.frame_encode(np.arange(4, dtype=np.uint8), cfg, tp),
                 lambda: tstream.frame_sync(np.zeros(4096, np.complex64), tp),
                 lambda: tstream.AdaptiveStreamDemodulator(tp).init_state(),
                 lambda: tstream.StreamDemodulator(tp, 8).init_state(),
                 lambda: tchirp.base_downchirp(7)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tstream.load_state(path, device="cpu").consumed == 5


@pytest.mark.gpu
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_adaptive_receiver_cuda_matches_cpu(adaptive_streams, soft):
    """The adaptive receiver on the card against the same blocks on the
    CPU, on the noisy stream: equal frame lists."""
    dev = cuda_device()
    streams, _, _ = adaptive_streams
    sig = streams["noisy"]
    frames = {}
    for d in (dev, "cpu"):
        demod = tstream.AdaptiveStreamDemodulator(tparams(P7), soft=soft, device=d)
        st, got = demod.init_state(), []
        for i in range(0, sig.size, 5003):
            st, out = demod.process(st, tt(sig[i:i + 5003]).to(d))
            got.extend(out)
        frames[str(d)] = got
    _assert_same_adaptive(frames[str(dev)], frames["cpu"])
    assert len(frames["cpu"]) == len(_ADAPTIVE_SPECS)
