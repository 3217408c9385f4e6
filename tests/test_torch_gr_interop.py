"""Port parity: lora_phy_tpu_torch.models.gr_interop (the gr-lora_sdr
interop: whitening, CRC, frame geometry, decode_frame / decode_bins hard
and soft, encode_frame) against the JAX package, on
``tests/test_e2e.py``'s loopback cases.

Decoded frames are bit-equal to JAX's: payload bytes, length, CR, CRC
flag, the raw trailer, crc_ok, header_ok, fec_errors, start and integer
CFO. ``encode_frame``'s IQ is bit-equal at SF7-10; at SF11-12 the chirp
emitter takes its trig path (the table over its budget) and the IQ
agrees within 5e-7 (ROADMAP Queue 3). The JAX side runs each
(SF, LDRO, implicit) cell at one coding rate (the four rates cycle over
the cells), soft as well as hard on half the cells; the port alone runs
every cell at all four rates, hard and soft, with ``test_e2e.py``'s
gates."""

import numpy as np
import pytest
import torch

from _torch_util import nn, tparams, tt
from lora_phy_tpu.models import gr_interop as jgr
from lora_phy_tpu.utils.params import LoraParams
from lora_phy_tpu_torch.models import gr_interop as tgr

PAYLOAD = b"cell \x00matrix\xff!"
TRIG_TX_ATOL = 5e-7


def _frame_fields(f):
    return None if f is None else dict(vars(f))


def _padded(iq, p):
    z = np.zeros(3 * p.step, np.complex64)
    return np.concatenate([z, iq, z])


def test_whitening_crc_and_plan_vs_jax():
    rng = np.random.RandomState(0)
    for n in (0, 1, 2, 14, 255, 300):
        data = rng.randint(0, 256, n).astype(np.uint8)
        np.testing.assert_array_equal(tgr.whiten_gr_lora(data), jgr.whiten_gr_lora(data))
        assert tgr.crc16_gr_lora(data.tobytes()) == jgr.crc16_gr_lora(data.tobytes())
    for sf in range(7, 13):
        for cr in range(1, 5):
            for length in (1, 14, 200):
                for crc in (False, True):
                    for ldro in (False, True):
                        for implicit in (False, True):
                            args = (sf, cr, length, crc, ldro, implicit)
                            assert tgr.payload_block_plan(*args) == jgr.payload_block_plan(*args)


def test_gr_interop_tx_rx_roundtrip():
    """test_e2e.py's round trip across coding rates: the port's frames
    decode to the JAX decoder's fields, and the JAX frames to the port's."""
    p = LoraParams(sf=7)
    payload = b"gr interop \x00\xff!"
    for cr in (1, 2, 3, 4):
        tiq = nn(tgr.encode_frame(payload, tparams(p), cr=cr, device="cpu"))
        jiq = np.asarray(jgr.encode_frame(payload, p, cr=cr))
        np.testing.assert_array_equal(tiq.view(np.uint32), jiq.view(np.uint32))
        sig = np.concatenate([np.zeros(200, np.complex64), tiq,
                              np.zeros(3 * p.step, np.complex64)])
        frame = tgr.decode_frame(tt(sig), tparams(p), tx_phase_step=None)
        assert _frame_fields(frame) == _frame_fields(
            jgr.decode_frame(sig, p, tx_phase_step=None))
        assert frame is not None and frame.header_ok
        assert frame.cr == cr and frame.length == len(payload)
        assert frame.payload == payload and frame.crc_ok and frame.fec_errors == 0


@pytest.mark.parametrize("sf", [7, 8, 9, 10, 11, 12])
@pytest.mark.parametrize("ldro", [False, True])
@pytest.mark.parametrize("implicit", [False, True])
def test_gr_interop_cell_matrix(sf, ldro, implicit):
    p = LoraParams(sf=sf)
    tp = tparams(p)
    jax_cr = 1 + (sf + 2 * ldro + implicit) % 4
    for cr in (1, 2, 3, 4):
        kw = dict(length=len(PAYLOAD), cr=cr, crc=True) if implicit else {}
        tiq = nn(tgr.encode_frame(PAYLOAD, tp, cr=cr, crc=True, ldro=ldro,
                                  implicit=implicit, device="cpu"))
        sig = tt(_padded(tiq, p))
        for soft in (False, True):
            frame = tgr.decode_frame(sig, tp, ldro=ldro, implicit=implicit, soft=soft,
                                     tx_phase_step=None, **kw)
            assert frame is not None and frame.header_ok, (cr, soft)
            assert frame.length == len(PAYLOAD) and frame.cr == cr
            assert frame.payload == PAYLOAD and frame.crc_ok
            assert frame.fec_errors == 0
        if cr != jax_cr:
            continue
        jiq = np.asarray(jgr.encode_frame(PAYLOAD, p, cr=cr, crc=True, ldro=ldro,
                                          implicit=implicit))
        if sf <= 10:
            np.testing.assert_array_equal(tiq.view(np.uint32), jiq.view(np.uint32))
        else:
            np.testing.assert_allclose(tiq, jiq, rtol=0, atol=TRIG_TX_ATOL)
        jsig = _padded(jiq, p)
        for soft in (False, True) if ldro == implicit else (False,):
            jf = jgr.decode_frame(jsig, p, ldro=ldro, implicit=implicit, soft=soft,
                                  tx_phase_step=None, **kw)
            tf = tgr.decode_frame(tt(jsig), tp, ldro=ldro, implicit=implicit, soft=soft,
                                  tx_phase_step=None, **kw)
            assert _frame_fields(tf) == _frame_fields(jf), soft


def test_decode_bins_vs_jax_on_corrupted_bins(monkeypatch):
    """decode_bins on bins with symbol errors: the same nibbles, FEC
    error counts, header verdicts and CRC verdicts as JAX, from numpy
    bins and from a tensor."""
    captured = {}

    def grab(symbols, params, preamble_len=8, **kw):
        captured["s"] = np.asarray(symbols).astype(np.int64)
        return np.zeros(1, np.complex64)

    monkeypatch.setattr(jgr.stream, "frame_modulate", grab)
    rng = np.random.RandomState(4)
    for sf, cr, ldro in ((7, 1, False), (8, 4, False), (9, 3, True), (12, 2, True)):
        p = LoraParams(sf=sf)
        jgr.encode_frame(PAYLOAD, p, cr=cr, ldro=ldro)
        bins = captured["s"]
        for trial in range(4):
            noisy = bins.copy()
            hit = rng.rand(bins.size) < 0.08 * trial
            noisy[hit] = (noisy[hit] + rng.randint(1, p.n, hit.sum())) % p.n
            jf = jgr.decode_bins(noisy, sf, ldro=ldro)
            assert _frame_fields(tgr.decode_bins(noisy, sf, ldro=ldro)) == _frame_fields(jf)
            assert _frame_fields(tgr.decode_bins(torch.from_numpy(noisy), sf,
                                                 ldro=ldro)) == _frame_fields(jf)


def test_gr_decode_bins_short_input_returns_none():
    assert tgr.decode_bins(np.zeros(5, np.int64), 7) is None
    assert tgr.decode_bins(np.zeros(5, np.int64), 7, soft=True,
                           mag2=np.zeros((5, 32), np.float32)) is None
    with pytest.raises(ValueError, match="mag2"):
        tgr.decode_bins(np.zeros(8, np.int64), 7, soft=True)
    with pytest.raises(ValueError, match="implicit"):
        tgr.decode_bins(np.zeros(8, np.int64), 7, implicit=True)
