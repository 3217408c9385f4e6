"""Port parity: the rest of lora_phy_tpu_torch.ops.coding (bit pack,
Hamming 7/4, parity 5/4 and 6/4, the three whiteners, header checksum,
checksum8, the interleavers) and lora_phy_tpu_torch.models.coded (the
coded chain and the explicit header) against the JAX package and the
reference's exhaustive truth tables (tests/fixtures/coding_truth.npz).

Every check is bit-exact: there are no floats in the coded chain.
Symbols are int32 in the port where JAX has uint16."""

import numpy as np
import pytest
import torch

from _torch_util import FIXTURES, nn, tt
from lora_phy_tpu.models import coded as jcoded
from lora_phy_tpu.ops import coding as jcoding
from lora_phy_tpu_torch.models import coded as tcoded
from lora_phy_tpu_torch.ops import coding as tcoding


@pytest.fixture(scope="module")
def truth():
    return np.load(FIXTURES / "coding_truth.npz")


def _eq(mine, ref, dtype=None):
    """Bit-equal as numpy arrays (``dtype``: compare JAX's array cast to
    the port's integer type, e.g. uint16 -> int32)."""
    ref = nn(ref)
    if dtype is not None:
        ref = ref.astype(dtype)
    mine = nn(mine)
    assert mine.shape == ref.shape, (mine.shape, ref.shape)
    np.testing.assert_array_equal(mine, ref)


# ---------------------------------------------------------------------------
# ops/coding.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbits", [4, 8, 12, 16])
def test_unpack_pack_bits_vs_jax(nbits):
    x = np.random.RandomState(nbits).randint(0, 1 << nbits, (3, 7)).astype(np.int32)
    bits = tcoding.unpack_bits(tt(x), nbits)
    assert bits.dtype == torch.int32
    _eq(bits, jcoding.unpack_bits(x, nbits))
    _eq(tcoding.pack_bits(bits), jcoding.pack_bits(nn(bits)), np.int32)
    _eq(tcoding.pack_bits(bits), x)
    u8 = tcoding.unpack_bits(tt(x.astype(np.uint8)), 8)
    assert u8.dtype == torch.uint8
    _eq(u8, jcoding.unpack_bits(x.astype(np.uint8), 8))


def test_hamming74_exhaustive(truth):
    enc = tcoding.hamming74_encode(torch.arange(16))
    assert enc.dtype == torch.uint8
    _eq(enc, truth["h74_enc"])
    _eq(enc, jcoding.hamming74_encode(np.arange(16)))
    nib, err = tcoding.hamming74_decode(torch.arange(128))
    _eq(nib, truth["h74_dec"])
    _eq(nn(err).astype(np.uint8), truth["h74_err"])
    for mine, ref in zip((nib, err), jcoding.hamming74_decode(np.arange(128))):
        _eq(mine, ref)
    # every single-bit error of every codeword is corrected
    for bit in range(7):
        nib, err = tcoding.hamming74_decode(enc.to(torch.int32) ^ (1 << bit))
        _eq(nib, np.arange(16, dtype=np.uint8))
        assert bool(err.all())


@pytest.mark.parametrize("name", ["parity54", "parity64"])
def test_parity_exhaustive(truth, name):
    width = {"parity54": 32, "parity64": 64}[name]
    enc = getattr(tcoding, f"{name}_encode")(torch.arange(16))
    _eq(enc, truth[f"{name[:1]}{name[6:]}_enc"])
    _eq(enc, getattr(jcoding, f"{name}_encode")(np.arange(16)))
    nib, err = getattr(tcoding, f"{name}_check")(torch.arange(width))
    assert nib.dtype == torch.uint8 and err.dtype == torch.bool
    _eq(nib, truth[f"{name[:1]}{name[6:]}_chk"])
    _eq(nn(err).astype(np.uint8), truth[f"{name[:1]}{name[6:]}_err"])
    for mine, ref in zip((nib, err), getattr(jcoding, f"{name}_check")(np.arange(width))):
        _eq(mine, ref)


def test_whitening_sx1232(truth):
    zeros = np.zeros(600, dtype=np.uint8)
    got = tcoding.whiten_sx1232(tt(zeros))
    _eq(got, truth["wh_sx1232"])
    _eq(got, jcoding.whiten_sx1232(zeros))
    data = np.arange(600, dtype=np.uint8)
    _eq(tcoding.whiten_sx1232(tcoding.whiten_sx1232(tt(data))), data)
    with pytest.raises(ValueError):
        tcoding.whiten_sx1232(torch.zeros(4097, dtype=torch.uint8))


@pytest.mark.parametrize("rdd", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("ofs", [0, 1, 7, 100])
def test_whitening_sx1272_seq(truth, rdd, ofs):
    zeros = np.zeros(600, dtype=np.uint8)
    got = tcoding.whiten_sx1272_seq(tt(zeros), bit_ofs=ofs, rdd=rdd)
    _eq(got, truth[f"wh_seq_r{rdd}_o{ofs}"])
    _eq(got, jcoding.whiten_sx1272_seq(zeros, bit_ofs=ofs, rdd=rdd))


@pytest.mark.parametrize("rdd", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("ofs", [0, 1, 7, 100])
def test_whitening_sx1272_lfsr(truth, rdd, ofs):
    zeros = np.zeros(600, dtype=np.uint8)
    got = tcoding.whiten_sx1272_lfsr(tt(zeros), bit_ofs=ofs, rdd=rdd)
    _eq(got, truth[f"wh_lfsr_r{rdd}_o{ofs}"])
    _eq(got, jcoding.whiten_sx1272_lfsr(zeros, bit_ofs=ofs, rdd=rdd))


@pytest.mark.parametrize("rdd", [1, 4])
def test_whitening_sx1272_lfsr_past_the_table(rdd):
    """A run that ends past the precomputed 4096 keystream bytes, and a
    batched input, as JAX."""
    data = np.random.RandomState(rdd).randint(0, 256, (2, 40)).astype(np.uint8)
    for ofs in (0, 4070, 5000):
        _eq(tcoding.whiten_sx1272_lfsr(tt(data), bit_ofs=ofs, rdd=rdd),
            jcoding.whiten_sx1272_lfsr(data, bit_ofs=ofs, rdd=rdd))


def test_keystream_tables_bit_equal():
    np.testing.assert_array_equal(tcoding._sx1232_stream(), jcoding._SX1232_STREAM)
    np.testing.assert_array_equal(tcoding._sx1272_seq_bits(), jcoding._SX1272_SEQ_BITS)
    for rdd_is_one in (True, False):
        np.testing.assert_array_equal(tcoding._sx1272_lfsr_stream(rdd_is_one),
                                      jcoding._SX1272_LFSR_STREAMS[rdd_is_one])
    for name in ("_H74_ENC", "_H74_DEC_NIB", "_H74_DEC_ERR", "_P54_ENC",
                 "_P54_CHK_ERR", "_P64_ENC", "_P64_CHK_ERR"):
        mine, ref = getattr(tcoding, name), getattr(jcoding, name)
        assert mine.dtype == ref.dtype, name
        np.testing.assert_array_equal(mine, ref, err_msg=name)


def test_whitening_fixture_roundtrip():
    """The reference's whitening unit fixture: DE AD BE EF 70 0D <->
    21 52 90 10 2C F2 with a valid trailing CRC
    (reference: tests/whitening_test.cpp:30-49)."""
    plain = np.array([0xDE, 0xAD, 0xBE, 0xEF, 0x70, 0x0D], dtype=np.uint8)
    expect = np.array([0x21, 0x52, 0x90, 0x10, 0x2C, 0xF2], dtype=np.uint8)
    _eq(tcoding.whiten_sx1272_lfsr(tt(plain), 0, 4), expect)
    _eq(tcoding.whiten_sx1272_lfsr(tt(expect), 0, 4), plain)
    assert int(tcoding.crc16_sx1272(tt(plain[:-2]))) == int(plain[-2]) | (int(plain[-1]) << 8)


def test_header_checksum_exhaustive(truth):
    """Every pair of header bytes against JAX, and the reference's 256
    truth pairs."""
    i = np.arange(256, dtype=np.uint8)
    h = np.stack([i, (i.astype(np.int64) * 37 + 11).astype(np.uint8)], axis=-1)
    _eq(tcoding.header_checksum(tt(h)), truth["header_chk"])
    every = np.stack(np.meshgrid(i, i, indexing="ij"), axis=-1).reshape(-1, 2)
    got = tcoding.header_checksum(tt(every))
    assert got.dtype == torch.uint8
    _eq(got, jcoding.header_checksum(every))


def test_checksum8(truth):
    blob = truth["crc_input"]
    for length in range(0, 256, 17):
        assert tcoding.checksum8(tt(blob[:length])) == truth["checksum8"][length]
        assert tcoding.checksum8(blob[:length]) == jcoding.checksum8(blob[:length])


@pytest.mark.parametrize("ppm", range(5, 13))
@pytest.mark.parametrize("rdd", [1, 2, 3, 4])
def test_interleave_maps_and_round_trip(ppm, rdd):
    """The gather maps (v2 included, for 1..3 blocks) equal JAX's, and
    the interleavers agree with JAX on random batched codewords."""
    np.testing.assert_array_equal(tcoding._interleave_map(ppm, rdd),
                                  jcoding._interleave_map(ppm, rdd))
    np.testing.assert_array_equal(tcoding._deinterleave_map(ppm, rdd),
                                  jcoding._deinterleave_map(ppm, rdd))
    for nblk in (1, 2, 3):
        for mine, ref in zip(tcoding._deinterleave_v2_map(ppm, rdd, nblk),
                             jcoding._deinterleave_v2_map(ppm, rdd, nblk)):
            np.testing.assert_array_equal(mine, ref)
    nbits = 4 + rdd
    rng = np.random.RandomState(ppm * 10 + rdd)
    cw = rng.randint(0, 1 << nbits, (2, 3, 3 * ppm + 1)).astype(np.uint8)
    syms = tcoding.diagonal_interleave(tt(cw), ppm, rdd)
    assert syms.dtype == torch.int32
    _eq(syms, jcoding.diagonal_interleave(cw, ppm, rdd), np.int32)
    back = tcoding.diagonal_deinterleave(syms, ppm, rdd)
    assert back.dtype == torch.uint8
    _eq(back, cw[..., : 3 * ppm])
    words = rng.randint(0, 1 << ppm, (2, 3 * nbits + 2)).astype(np.int32)
    _eq(tcoding.diagonal_deinterleave(tt(words), ppm, rdd),
        jcoding.diagonal_deinterleave(words.astype(np.uint16), ppm, rdd))
    _eq(tcoding.diagonal_deinterleave_v2(tt(words), ppm, rdd),
        jcoding.diagonal_deinterleave_v2(words.astype(np.uint16), ppm, rdd))


@pytest.mark.parametrize("ppm", [7, 8, 10, 12])
@pytest.mark.parametrize("rdd", [0, 1, 2, 3, 4])
def test_interleaver_truth(truth, ppm, rdd):
    cw = truth[f"il_cw_p{ppm}_r{rdd}"]
    sym = truth[f"il_sym_p{ppm}_r{rdd}"]
    _eq(tcoding.diagonal_interleave(tt(cw), ppm, rdd), sym, np.int32)
    _eq(tcoding.diagonal_deinterleave(tt(sym.astype(np.int32)), ppm, rdd),
        truth[f"il_cwback_p{ppm}_r{rdd}"])
    got = nn(tcoding.diagonal_deinterleave_v2(tt(sym.astype(np.int32)), ppm, rdd))
    _eq(got, jcoding.diagonal_deinterleave_v2(sym, ppm, rdd))
    ref = truth[f"il_cwback2_p{ppm}_r{rdd}"]
    nb = 4 + rdd
    if ppm > nb:
        # the reference's final block reads past the symbol array (UB);
        # compare only the deterministic prefix (as tests/test_coding.py)
        nblk = len(sym) // nb
        got, ref = got[: (nblk - 1) * ppm], ref[: (nblk - 1) * ppm]
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# models/coded.py
# ---------------------------------------------------------------------------

def test_payload_symbol_count_vs_jax():
    for sf in range(7, 13):
        for cr in range(1, 5):
            for ldro in (False, True):
                for crc in (False, True):
                    j = jcoded.CodedConfig(sf=sf, cr=cr, ldro=ldro, crc=crc)
                    t = tcoded.CodedConfig(sf=sf, cr=cr, ldro=ldro, crc=crc)
                    assert (t.ppm, t.rdd, t.bits_per_symbol) == (j.ppm, j.rdd, j.bits_per_symbol)
                    for nbytes in (0, 1, 13, 255):
                        assert tcoded.payload_symbol_count(nbytes, t) == \
                            jcoded.payload_symbol_count(nbytes, j)
    assert tcoded.HEADER_RDD == jcoded.HEADER_RDD


@pytest.mark.parametrize("sf", range(7, 13))
@pytest.mark.parametrize("cr", [1, 2, 3, 4])
@pytest.mark.parametrize("ldro", [False, True], ids=["noldro", "ldro"])
def test_encode_decode_payload_vs_jax(sf, cr, ldro):
    """Batched payloads through every CRC x whitening mode: symbols and
    decoded (payload, crc_ok, fec_errors) bit-equal to JAX."""
    rng = np.random.RandomState(sf * 100 + cr * 10 + ldro)
    # one payload shape for every case: JAX compiles its ops once per shape
    payload = rng.randint(0, 256, (2, 3, 23)).astype(np.uint8)
    for crc in (False, True):
        for whiten in (False, True):
            jc = jcoded.CodedConfig(sf=sf, cr=cr, ldro=ldro, crc=crc, whiten=whiten)
            tc = tcoded.CodedConfig(sf=sf, cr=cr, ldro=ldro, crc=crc, whiten=whiten)
            ref = nn(jcoded.encode_payload(payload, jc))
            syms = tcoded.encode_payload(tt(payload), tc)
            assert syms.dtype == torch.int32
            _eq(syms, ref, np.int32)
            out = tcoded.decode_payload(syms, payload.shape[-1], tc)
            for mine, theirs in zip(out, jcoded.decode_payload(ref, payload.shape[-1], jc)):
                _eq(mine, nn(theirs).astype(nn(mine).dtype))
            _eq(out[0], payload)
            assert bool(out[1].all()) and int(out[2].sum()) == 0


@pytest.mark.parametrize("sf", range(7, 13))
def test_ldro_demap_every_bin(sf):
    """LDRO decode of every bin 0..N-1 and of 16-bit values past N (where
    JAX wraps ``s + 2`` in uint16): the same payload, crc_ok and
    fec_errors as JAX, and the same words in the port's int32 arithmetic
    as JAX's uint16 one."""
    n = 1 << sf
    cfg_j = jcoded.CodedConfig(sf=sf, cr=4, ldro=True)
    cfg_t = tcoded.CodedConfig(sf=sf, cr=4, ldro=True)
    extra = np.array([n, n + 1, 4 * n - 3, 65533, 65534, 65535])
    bins = np.concatenate([np.arange(n), extra])
    bins = np.concatenate([bins, np.zeros((-bins.size) % 8, np.int64)])
    frames = bins.reshape(-1, 8).astype(np.int32)          # one block each
    nbytes = (sf - 2) // 2 - 2 if sf >= 10 else 0
    for mine, theirs in zip(tcoded.decode_payload(tt(frames), nbytes, cfg_t),
                            jcoded.decode_payload(frames.astype(np.uint16), nbytes, cfg_j)):
        _eq(mine, nn(theirs).astype(nn(mine).dtype))
    s16 = bins.astype(np.uint16)
    ref = ((s16 + np.uint16(2)) >> np.uint16(2)) % np.uint16(n >> 2)
    _eq(tcoded._ldro_demap(tt(bins.astype(np.int32)), sf), ref, np.int32)


@pytest.mark.parametrize("sf", range(7, 13))
def test_encode_header_vs_jax(sf):
    """Header symbols for payload lengths 0..255 (every length at SF7, a
    spread at SF8-12) with CR cycling and CRC alternating, bit-equal to
    JAX, and decode_header's fields equal JAX's on them."""
    lengths = range(256) if sf == 7 else (0, 1, 2, 77, 128, 254, 255)
    for k, nbytes in enumerate(lengths):
        jc = jcoded.CodedConfig(sf=sf, cr=1 + k % 4, crc=bool(k % 2))
        tc = tcoded.CodedConfig(sf=sf, cr=1 + k % 4, crc=bool(k % 2))
        ref = nn(jcoded.encode_header(nbytes, jc))
        hdr = tcoded.encode_header(nbytes, tc, device="cpu")
        assert hdr.dtype == torch.int32 and tuple(hdr.shape) == (8,)
        _eq(hdr, ref, np.int32)
        got = tcoded.decode_header(hdr, sf)
        assert got == (nbytes, 1 + k % 4, bool(k % 2), True)
        assert got == tuple(jcoded.decode_header(ref, sf))


def test_decode_header_corrupted_vs_jax():
    """Corrupted header symbols: the same (nbytes, cr, crc, ok) as JAX,
    rejected where the 5-bit checksum catches the damage."""
    rng = np.random.RandomState(21)
    rejected = 0
    for sf in (7, 9, 12):
        for trial in range(20):
            jc = jcoded.CodedConfig(sf=sf, cr=1 + trial % 4)
            hdr = nn(jcoded.encode_header(int(rng.randint(1, 256)), jc)).astype(np.int32)
            k = rng.randint(0, 8, size=1 + trial % 3)
            hdr[k] = rng.randint(0, 1 << sf, size=k.size)
            got = tcoded.decode_header(tt(hdr), sf)
            assert got == tuple(jcoded.decode_header(hdr.astype(np.uint16), sf))
            rejected += not got[3]
    assert rejected > 0


@pytest.mark.parametrize("cr", [1, 2, 3, 4])
def test_corrupted_symbols_vs_jax(cr):
    """Random symbol errors: the same bytes, crc_ok and fec_errors as
    JAX — corrected for CR 4/7-4/8, detected for CR 4/5-4/6."""
    rng = np.random.RandomState(30 + cr)
    payload = rng.randint(0, 256, (16, 20)).astype(np.uint8)
    jc = jcoded.CodedConfig(sf=8, cr=cr)
    tc = tcoded.CodedConfig(sf=8, cr=cr)
    syms = nn(jcoded.encode_payload(payload, jc)).astype(np.int32)
    for f in range(16):
        k = rng.randint(0, syms.shape[-1], size=f % 4)
        syms[f, k] ^= 1 << rng.randint(0, 8, size=k.size)
    got = tcoded.decode_payload(tt(syms), 20, tc)
    ref = jcoded.decode_payload(syms.astype(np.uint16), 20, jc)
    for mine, theirs in zip(got, ref):
        _eq(mine, nn(theirs).astype(nn(mine).dtype))
    assert int(got[2].sum()) > 0 and not bool(got[1].all())


def test_encode_payload_takes_arrays_only_with_a_device(monkeypatch):
    """Arrays without ``device=`` go to the first CUDA card, and with no
    card that raises; encode_header makes its tensor there too."""
    payload = np.arange(6, dtype=np.uint8)
    cfg = tcoded.CodedConfig()
    got = tcoded.encode_payload(payload, cfg, device="cpu")
    _eq(got, jcoded.encode_payload(payload, jcoded.CodedConfig()), np.int32)
    assert torch.equal(tcoded.encode_payload(tt(payload), cfg), got)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcoded.encode_payload(payload, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcoded.encode_header(6, cfg)
