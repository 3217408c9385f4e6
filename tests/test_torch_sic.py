"""Port parity: lora_phy_tpu_torch.models.sic (successive interference
cancellation) against lora_phy_tpu.models.sic on tests/test_sic.py's
collision cases: the weak frame under a strong one, a CFO on the strong
frame, disjoint frames, the three-frame pileup, the joint re-fit with and
without refinement, the robust mode, and the front-end correction that
frees a frame below the IQ-image floor.

The frame lists are bit-equal: count, start, sync, cfo_bins, sic_pass and
symbols, in order. Floats: the residual CFO within 1e-5 bins (the joint
re-fit moves it by phase slopes of float32 inner products summed in
another order, and reruns while a frame's step exceeds 1e-6 bins), the
fitted gains within 1e-4 relative to their magnitude, the cancellation
depth held to JAX's own gates (a residual at -100 dB is float32 rounding,
not a value to compare).
"""

import numpy as np
import pytest
import torch

from _torch_util import nn, tparams, tt
from lora_phy_tpu.models import modem as jmodem
from lora_phy_tpu.models import sic as jsic
from lora_phy_tpu.models import stream as jstream
from lora_phy_tpu.ops import impair as jimpair
from lora_phy_tpu.ops import planar as jplanar
from lora_phy_tpu.utils.params import LoraParams
from lora_phy_tpu_torch.models import modem as tmodem
from lora_phy_tpu_torch.models import sic as tsic
from lora_phy_tpu_torch.models import sync as tsync
from lora_phy_tpu_torch.ops import impair as timpair

CFO_ATOL = 1e-5
GAIN_RTOL = 1e-4


def _frame(p, payload, amplitude=1.0):
    return np.asarray(jstream.frame_modulate(jmodem.encode(payload), p,
                                             amplitude=amplitude))


def _place(frames_and_offsets, total):
    out = np.zeros(total, np.complex64)
    for iq, off in frames_and_offsets:
        out[off: off + iq.size] += iq
    return out


def _both(s, p, n_payload, **kw):
    """receive_sic_planar in both packages on the same planes; asserts the
    frame lists agree and returns the port's frames and residual."""
    re, im = jplanar.split_complex(s) if np.iscomplexobj(s) else s
    ref, (rr, ri) = jsic.receive_sic_planar(re, im, p, n_payload, **kw)
    got, (gr, gi) = tsic.receive_sic_planar(tt(re), tt(im), tparams(p), n_payload, **kw)
    assert len(got) == len(ref), ([f["start"] for f in got], [f["start"] for f in ref])
    for a, b in zip(got, ref):
        for key in ("start", "sync", "cfo_bins", "sic_pass"):
            assert a[key] == b[key], (key, a[key], b[key])
        np.testing.assert_array_equal(nn(a["symbols"]), np.asarray(b["symbols"]).astype(np.int32))
        assert abs(a["cfo"] - b["cfo"]) <= CFO_ATOL, (a["cfo"], b["cfo"])
        ga, gb = complex(*a["gain"]), complex(*b["gain"])
        assert abs(ga - gb) <= GAIN_RTOL * abs(gb), (ga, gb)
        assert np.isfinite(a["cancel_resid_db"])
    resid = float(np.sum(nn(gr) ** 2 + nn(gi) ** 2))
    ref_resid = float(np.sum(np.asarray(rr) ** 2 + np.asarray(ri) ** 2))
    total = float(np.sum(re.astype(np.float64) ** 2 + im.astype(np.float64) ** 2))
    assert abs(resid - ref_resid) <= 1e-4 * total
    return got, ref


def _decodes(frames, payloads):
    for f, pay in zip(frames, payloads):
        np.testing.assert_array_equal(nn(tmodem.decode(tt(nn(f["symbols"])))), pay)


@pytest.mark.parametrize("refine", [True, False])
def test_single_frame_cancellation_depth(refine):
    """A clean frame cancels to the float32 floor (below -40 dB), the
    fitted gain ~ the TX amplitude, nothing left above the -30 dB gate."""
    p = LoraParams(sf=7)
    payload = np.random.RandomState(1).randint(0, 256, 6).astype(np.uint8)
    iq = _frame(p, payload, amplitude=0.7)
    s = _place([(iq, 3 * p.step)], iq.size + 6 * p.step)
    got, ref = _both(s, p, payload.size * 2, refine=refine)
    assert len(got) == 1 and got[0]["start"] == 3 * p.step
    _decodes(got, [payload])
    assert got[0]["cancel_resid_db"] < -40.0 and ref[0]["cancel_resid_db"] < -40.0
    assert abs(abs(complex(*got[0]["gain"])) - 0.7) < 1e-3
    _, (rr, ri) = tsic.receive_sic_planar(*(tt(a) for a in jplanar.split_complex(s)),
                                          tparams(p), payload.size * 2, refine=refine)
    assert not bool(tsync.frame_sync_scan_planar(rr, ri, tparams(p),
                                                 min_power_db=-30.0).valid.any())


def test_collision_recovers_weak_frame():
    """Two same-SF frames 12 dB apart, payloads overlapping: one pass never
    gets the weak frame right; SIC peels the strong one and decodes both,
    in both packages alike."""
    p = LoraParams(sf=7)
    rng = np.random.RandomState(2)
    pay_a = rng.randint(0, 256, 6).astype(np.uint8)
    pay_b = rng.randint(0, 256, 6).astype(np.uint8)
    off_a, off_b = 2 * p.step, 7 * p.step
    fb = _frame(p, pay_b, amplitude=0.25)
    s = _place([(_frame(p, pay_a), off_a), (fb, off_b)], fb.size + off_b + 4 * p.step)
    blk = tsync.receive_block_planar(*(tt(a) for a in jplanar.split_complex(s)),
                                     tparams(p), 12)
    rows = {r["start"]: r for r in tsync.block_rows(blk)}
    assert off_b not in rows or not np.array_equal(
        nn(tmodem.decode(rows[off_b]["symbols"])), pay_b)
    got, ref = _both(s, p, 12)
    assert [f["start"] for f in got] == [off_a, off_b]
    assert [f["sic_pass"] for f in got] == [0, 1]
    _decodes(got, [pay_a, pay_b])
    assert abs(abs(complex(*got[0]["gain"])) - 1.0) < 0.1
    assert abs(abs(complex(*got[1]["gain"])) - 0.25) < 0.02


def test_collision_with_cfo_on_strong_frame():
    p = LoraParams(sf=7)
    rng = np.random.RandomState(3)
    pay_a = rng.randint(0, 256, 6).astype(np.uint8)
    pay_b = rng.randint(0, 256, 6).astype(np.uint8)
    fa = nn(timpair.apply_cfo_continuous(torch.from_numpy(_frame(p, pay_a).copy()), 2.3,
                                         p.n, p.osr))
    np.testing.assert_allclose(fa, np.asarray(jimpair.apply_cfo_continuous(
        _frame(p, pay_a), 2.3, p.n, p.osr)), rtol=0, atol=1e-6)
    fb = _frame(p, pay_b, amplitude=0.3)
    off_a, off_b = 2 * p.step, 8 * p.step
    s = _place([(fa, off_a), (fb, off_b)], fb.size + off_b + 4 * p.step)
    got, _ = _both(s, p, 12)
    assert [f["start"] for f in got] == [off_a, off_b]
    assert got[0]["cfo_bins"] == 2
    _decodes(got, [pay_a, pay_b])


def test_disjoint_frames_both_found_first_pass():
    p = LoraParams(sf=7)
    rng = np.random.RandomState(4)
    pay_a = rng.randint(0, 256, 4).astype(np.uint8)
    pay_b = rng.randint(0, 256, 4).astype(np.uint8)
    fa, fb = _frame(p, pay_a, 0.9), _frame(p, pay_b, 0.5)
    off_a = p.step
    off_b = off_a + fa.size + 3 * p.step
    s = _place([(fa, off_a), (fb, off_b)], off_b + fb.size + 3 * p.step)
    got, _ = _both(s, p, 8)
    assert [f["start"] for f in got] == [off_a, off_b]
    _decodes(got, [pay_a, pay_b])


def test_three_frame_pileup_power_ordered_peel():
    p = LoraParams(sf=7)
    rng = np.random.RandomState(5)
    pays = [rng.randint(0, 256, 6).astype(np.uint8) for _ in range(3)]
    amps = [1.0, 0.4, 0.16]
    offs = [2 * p.step, 6 * p.step, 11 * p.step]
    frames = [_frame(p, pay, a) for pay, a in zip(pays, amps)]
    total = max(o + f.size for o, f in zip(offs, frames)) + 6 * p.step
    s = _place(list(zip(frames, offs)), total)
    got, _ = _both(s, p, 12)
    assert [f["start"] for f in got] == offs
    assert [f["sic_pass"] for f in got] == [0, 1, 2]
    _decodes(got, pays)


def test_joint_refit_fixes_cfo_bias_and_decisions():
    """Sequential peeling's CFO bias corrupts the -12 dB partner
    (refine=False, in both packages alike); the joint re-fit decodes both,
    cancels below -60 dB and recovers each CFO within 0.01 bin."""
    p = LoraParams(sf=7)
    rng = np.random.RandomState(11)
    pay_a = rng.randint(0, 256, 8).astype(np.uint8)
    pay_b = rng.randint(0, 256, 8).astype(np.uint8)

    def tx(pay, amp, cfo):
        x = _frame(p, pay, amplitude=amp)
        return x * np.exp(2j * np.pi * cfo / p.n * np.arange(x.size)).astype(np.complex64)

    s = _place([(tx(pay_a, 1.0, 0.3), 2 * p.step), (tx(pay_b, 0.25, -0.2), 5 * p.step)],
               3 * p.step + tx(pay_a, 1.0, 0.3).size + 4 * p.step)
    seq, _ = _both(s, p, 16, refine=False)
    weak = [f for f in seq if f["start"] == 5 * p.step][0]
    assert (nn(tmodem.decode(tt(nn(weak["symbols"])))) != pay_b).sum() > 0
    got, ref = _both(s, p, 16, refine=True)
    assert [f["start"] for f in got] == [2 * p.step, 5 * p.step]
    _decodes(got, [pay_a, pay_b])
    for f, r, true_cfo in zip(got, ref, (0.3, -0.2)):
        assert f["cancel_resid_db_joint"] < -60.0 and r["cancel_resid_db_joint"] < -60.0
        assert abs(f["cfo_bins"] + f["cfo"] - true_cfo) < 0.01


def test_robust_mode_composes_with_sic():
    """tests/test_sync.py's composition case: pre_acc=3 through the SIC
    loop, both frames at their starts with their payloads."""
    p = LoraParams(sf=7)
    rng = np.random.RandomState(27)
    pay_a = rng.randint(0, 256, 4).astype(np.uint8)
    pay_b = rng.randint(0, 256, 4).astype(np.uint8)
    fa, fb = _frame(p, pay_a), 0.3 * _frame(p, pay_b)
    s = np.zeros(2 * p.step + fb.size + 5 * p.step + fb.size, np.complex64)
    s[2 * p.step: 2 * p.step + fa.size] += fa
    s[7 * p.step: 7 * p.step + fb.size] += fb
    got, _ = _both(s, p, 8, pre_acc=3)
    assert [f["start"] for f in got] == [2 * p.step, 7 * p.step]
    _decodes(got, [pay_a, pay_b])


def test_frontend_correction_rescues_deep_sic():
    """tests/test_offsets.py's case: an IQ imbalance leaks every chirp's
    image at ~-19 dB, burying a -23 dB colliding frame; after the blind
    front-end estimate and compensation SIC decodes it (the
    ``--frontend-correct`` loop), in both packages alike."""
    p = LoraParams(sf=7)
    rng = np.random.RandomState(2)
    pay_a = rng.randint(0, 256, 6).astype(np.uint8)
    pay_b = rng.randint(0, 256, 6).astype(np.uint8)
    fa = _frame(p, pay_a)
    fb = 0.07 * _frame(p, pay_b)
    s = np.zeros(7 * p.step + fb.size + 4 * p.step, np.complex64)
    s[2 * p.step: 2 * p.step + fa.size] += fa
    s[7 * p.step: 7 * p.step + fb.size] += fb.astype(np.complex64)
    bad = nn(timpair.apply_frontend(torch.from_numpy(s), dc=0.05 - 0.03j,
                                    gain_imbalance=1.2, phase_skew_deg=6.0))
    re, im = jplanar.split_complex(bad)

    def weak_ok(frames):
        return any(np.array_equal(nn(tmodem.decode(tt(nn(f["symbols"])))), pay_b)
                   for f in frames)

    got, _ = _both((re, im), p, 12)
    assert not weak_ok(got)
    from lora_phy_tpu_torch.ops.impair import (compensate_frontend_planar,
                                               estimate_frontend_planar)
    est = estimate_frontend_planar(tt(re), tt(im))
    cr, ci = compensate_frontend_planar(tt(re), tt(im), *est)
    got, _ = _both((nn(cr), nn(ci)), p, 12)
    assert weak_ok(got)


# ---------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------

def test_cancel_frame_planar_vs_jax():
    """One cancel on a stream with a second frame under it: planes within
    1e-6, gain within GAIN_RTOL, depth within 1e-3 dB (well above the
    rounding floor here: the second frame remains); a start past the end
    leaves the block."""
    p = LoraParams(sf=7)
    rng = np.random.RandomState(12)
    pay_a = rng.randint(0, 256, 6).astype(np.uint8)
    pay_b = rng.randint(0, 256, 6).astype(np.uint8)
    fa, fb = _frame(p, pay_a), _frame(p, pay_b, 0.3)
    s = _place([(fa, 2 * p.step), (fb, 6 * p.step)], fb.size + 10 * p.step)
    re, im = jplanar.split_complex(s)
    syms = np.asarray(jmodem.encode(pay_a)).astype(np.int32)
    for start, cfo in ((2 * p.step, 0.01), (re.size + 50, 0.0)):
        ref = jsic.cancel_frame_planar(re, im, syms, np.int32(start), np.float32(cfo), p,
                                       sync_word=np.uint8(0x12))
        got = tsic.cancel_frame_planar(tt(re), tt(im), tt(syms), start, cfo, tparams(p),
                                       sync_word=0x12)
        np.testing.assert_allclose(nn(got[0]), np.asarray(ref[0]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(nn(got[1]), np.asarray(ref[1]), rtol=0, atol=1e-6)
        g, rg = complex(float(got[2][0]), float(got[2][1])), complex(*(float(v) for v in ref[2]))
        assert abs(g - rg) <= GAIN_RTOL * max(abs(rg), 1e-6)
        if start < re.size:
            assert abs(float(got[3]) - float(ref[3])) <= 1e-3
            assert float(got[3]) < -3.0        # the weak frame stays under it


def test_embed_template_and_cfo_slope_vs_jax():
    p = LoraParams(sf=7)
    syms = np.random.RandomState(13).randint(0, 128, 12).astype(np.int32)
    t_len = 40 * p.step
    for start in (0, 3 * p.step + 17, t_len - 100):
        ref = jsic._embed_template_planar(syms, np.int32(start), np.float32(0.37),
                                          np.uint8(0x34), t_len, p, 8)
        got = tsic._embed_template_planar(tt(syms), start, 0.37, 0x34, t_len, tparams(p), 8)
        for a, b in zip(got, ref):
            assert a.shape == (t_len,)
            np.testing.assert_allclose(nn(a), np.asarray(b), rtol=0, atol=1e-6)
    er, ei = (np.asarray(a) for a in jsic._embed_template_planar(
        syms, np.int32(300), np.float32(0.0), np.uint8(0x12), t_len, p, 8))
    ph = 2 * np.pi * 0.004 * np.arange(t_len) / p.step
    y = (er + 1j * ei) * 0.8 * np.exp(1j * (ph + 0.3))
    yr, yi = jplanar.split_complex(y.astype(np.complex64))
    ref = float(jsic._cfo_slope_planar(yr, yi, er, ei, p.step))
    got = float(tsic._cfo_slope_planar(tt(yr), tt(yi), tt(er), tt(ei), p.step))
    assert abs(ref - 0.004) < 1e-4 and abs(got - ref) <= 1e-6


def test_refine_sic_mutates_copies_alike():
    """refine_sic_planar on copies of the same peeled frame list: the
    same in-place updates (cfo, gain, cancel_resid_db_joint) in both
    packages, and an empty list returns the planes."""
    p = LoraParams(sf=7)
    rng = np.random.RandomState(14)
    pays = [rng.randint(0, 256, 6).astype(np.uint8) for _ in range(2)]
    s = _place([(_frame(p, pays[0]), 2 * p.step), (_frame(p, pays[1], 0.3), 6 * p.step)],
               34 * p.step)
    re, im = jplanar.split_complex(s)
    rows = []
    for k, (pay, st) in enumerate(zip(pays, (2 * p.step, 6 * p.step))):
        rows.append({"start": st, "symbols": np.asarray(jmodem.encode(pay)).astype(np.int32),
                     "sync": 0x12, "cfo_bins": 0, "cfo": 0.002 * (k + 1), "snr_db": 30.0})
    jrows = [dict(r) for r in rows]
    trows = [dict(r, symbols=tt(r["symbols"])) for r in rows]
    jsic.refine_sic_planar(re, im, jrows, p)
    out = tsic.refine_sic_planar(tt(re), tt(im), trows, tparams(p))
    for a, b in zip(trows, jrows):
        assert abs(a["cfo"] - b["cfo"]) <= CFO_ATOL
        assert abs(complex(*a["gain"]) - complex(*b["gain"])) <= GAIN_RTOL * abs(complex(*b["gain"]))
        assert a["cancel_resid_db_joint"] < -40.0 and b["cancel_resid_db_joint"] < -40.0
    assert float((out[0] ** 2 + out[1] ** 2).sum()) < 1e-4 * float((re ** 2 + im ** 2).sum())
    empty = tsic.refine_sic_planar(tt(re), tt(im), [], tparams(p))
    assert torch.equal(empty[0], tt(re))
