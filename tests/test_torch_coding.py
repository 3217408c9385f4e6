"""Port parity: lora_phy_tpu_torch.ops.coding (main-path subset) against
the JAX module and the reference's exhaustive truth tables
(tests/fixtures/coding_truth.npz). Every check is bit-exact."""

import numpy as np
import pytest
import torch

from _torch_util import FIXTURES, GOLDEN, nn, tt
from lora_phy_tpu.models import modem as jmodem
from lora_phy_tpu.ops import coding as jcoding
from lora_phy_tpu_torch.models import modem as tmodem
from lora_phy_tpu_torch.ops import coding as tcoding


@pytest.fixture(scope="module")
def truth():
    return np.load(FIXTURES / "coding_truth.npz")


def test_hamming84_encode_exhaustive(truth):
    x = np.arange(16)
    got = nn(tcoding.hamming84_encode(tt(x)))
    np.testing.assert_array_equal(got, truth["h84_enc"])
    np.testing.assert_array_equal(got, nn(jcoding.hamming84_encode(x)))


def test_hamming84_decode_exhaustive(truth):
    x = np.arange(256)
    nib, err, bad = (nn(a) for a in tcoding.hamming84_decode(tt(x)))
    np.testing.assert_array_equal(nib, truth["h84_dec"])
    np.testing.assert_array_equal(err.astype(np.uint8), truth["h84_err"])
    np.testing.assert_array_equal(bad.astype(np.uint8), truth["h84_bad"])
    for mine, ref in zip((nib, err, bad), jcoding.hamming84_decode(x)):
        np.testing.assert_array_equal(mine, nn(ref))


def test_hamming84_single_error_correction():
    codes = tcoding.hamming84_encode(torch.arange(16))
    for bit in range(8):
        nib, err, bad = tcoding.hamming84_decode(codes.to(torch.int32) ^ (1 << bit))
        np.testing.assert_array_equal(nn(nib), np.arange(16))
        assert bool(err.all()) and not bool(bad.any())


def test_gray_16bit_exhaustive(truth):
    x = np.arange(65536, dtype=np.uint16)
    enc = nn(tcoding.binary_to_gray(tt(x)))
    dec = nn(tcoding.gray_to_binary(tt(x)))
    np.testing.assert_array_equal(enc, truth["gray_enc"])
    np.testing.assert_array_equal(dec, truth["gray_dec"])
    np.testing.assert_array_equal(enc, nn(jcoding.binary_to_gray(x)))
    np.testing.assert_array_equal(dec, nn(jcoding.gray_to_binary(x)))
    np.testing.assert_array_equal(
        nn(tcoding.gray_to_binary(tcoding.binary_to_gray(tt(x)))), x)


def test_nibbles_roundtrip_vs_jax():
    data = np.random.RandomState(4).randint(0, 256, (3, 5, 7)).astype(np.uint8)
    nib = tcoding.bytes_to_nibbles(tt(data))
    assert nib.dtype == torch.uint8 and nib.shape == (3, 5, 14)
    np.testing.assert_array_equal(nn(nib), nn(jcoding.bytes_to_nibbles(data)))
    np.testing.assert_array_equal(nn(tcoding.nibbles_to_bytes(nib)), data)


@pytest.mark.parametrize("length", [0, 1, 28, 255])
def test_crc16_vs_jax_and_truth(truth, length):
    blob = truth["crc_input"][:length]
    got = int(tcoding.crc16_sx1272(tt(blob)))
    assert got == int(truth["crc_by_len"][length])
    assert got == int(jcoding.crc16_sx1272(blob))


def test_crc16_all_lengths_vs_truth(truth):
    """Every length 0..255 of the reference's truth blob (port only: the
    JAX twin is held at a handful of lengths above)."""
    blob = truth["crc_input"]
    got = [int(tcoding.crc16_sx1272(tt(blob[:n]))) for n in range(256)]
    np.testing.assert_array_equal(got, truth["crc_by_len"].astype(np.int64))


def test_crc16_batched(truth):
    blob = truth["crc_input"]
    batch = np.stack([blob[:16], blob[16:32], blob[32:48]])
    got = nn(tcoding.crc16_sx1272(tt(batch)))
    np.testing.assert_array_equal(got, nn(jcoding.crc16_sx1272(batch)))
    with pytest.raises(ValueError):
        tcoding.crc16_sx1272(torch.zeros(256, dtype=torch.uint8))


def test_decode_with_crc_vs_jax():
    rng = np.random.RandomState(8)
    data = rng.randint(0, 256, (4, 14)).astype(np.uint8)
    crc = nn(jcoding.crc16_sx1272(data[:, 2:])).astype(np.uint16)
    payload = np.concatenate(
        [data, (crc & 0xFF)[:, None], (crc >> 8)[:, None]], axis=1).astype(np.uint8)
    payload[3, 5] ^= 0x40                       # one frame fails its CRC
    syms = jmodem.encode(payload)
    ref = jmodem.decode_with_crc(syms)
    got = tmodem.decode_with_crc(tt(syms).to(torch.int32))
    np.testing.assert_array_equal(nn(got.payload), nn(ref.payload))
    np.testing.assert_array_equal(nn(got.crc_ok), nn(ref.crc_ok))
    assert nn(got.crc_ok).tolist() == [True, True, True, False]


def test_encode_takes_arrays_only_with_a_device(monkeypatch):
    """An array without ``device=`` goes to the first CUDA card; with no
    card that raises (no silent CPU fallback), and CPU work says so."""
    payload = np.arange(6, dtype=np.uint8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodem.encode(payload)
    got = tmodem.encode(payload, device="cpu")
    np.testing.assert_array_equal(nn(got), nn(jmodem.encode(payload)).astype(np.int32))
    assert torch.equal(tmodem.encode(tt(payload)), got)


@pytest.mark.parametrize("path", GOLDEN, ids=lambda p: p.stem)
def test_encode_decode_golden(path):
    """encode == the reference's symbols; decode of the reference's demod
    symbols == its decoded bytes (int32 symbols where JAX has uint16)."""
    g = np.load(path)
    syms = tmodem.encode(tt(g["payload"]))
    assert syms.dtype == torch.int32
    np.testing.assert_array_equal(nn(syms), g["symbols"].astype(np.int32))
    np.testing.assert_array_equal(nn(tmodem.decode(tt(g["demod"]).to(torch.int32))),
                                  g["decoded"])
