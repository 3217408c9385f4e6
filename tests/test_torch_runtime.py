"""The port's native runtime binding (``lora_phy_tpu_torch.runtime``):
``tests/test_runtime.py``'s cases against the port's binding, which builds
``runtime/lora_runtime.cpp`` into ``build/lora_phy_tpu_torch/`` and leaves
``runtime/`` as it is."""

import hashlib
import pathlib

import numpy as np
import pytest
import torch

from lora_phy_tpu_torch import runtime

from _torch_util import nn, tparams, tt

REPO = pathlib.Path(__file__).resolve().parents[1]


def _tracked_runtime_digest() -> dict:
    """SHA-256 of the tracked files under runtime/."""
    out = {}
    for name in ("Makefile", "lora_runtime.cpp"):
        out[name] = hashlib.sha256((REPO / "runtime" / name).read_bytes()).hexdigest()
    return out


@pytest.fixture(scope="module", autouse=True)
def built():
    digest = _tracked_runtime_digest()
    runtime.lib()
    yield
    assert _tracked_runtime_digest() == digest


def test_library_lands_in_build_dir():
    """The library is built under build/lora_phy_tpu_torch/, from the
    repo-root source, and is newer than the source."""
    assert runtime.LIBRARY == REPO / "build" / "lora_phy_tpu_torch" / "liblora_runtime.so"
    assert runtime.SOURCE == REPO / "runtime" / "lora_runtime.cpp"
    assert runtime.LIBRARY.exists()
    assert runtime.LIBRARY.stat().st_mtime >= runtime.SOURCE.stat().st_mtime
    assert runtime.build() == runtime.LIBRARY          # up to date: no rebuild


def test_build_writes_only_its_library(monkeypatch, tmp_path):
    """A forced build writes the library where it is told and nothing
    into runtime/ (the JAX package's build directory)."""
    monkeypatch.setattr(runtime, "LIBRARY", tmp_path / "liblora_runtime.so")
    ours_before = {p.name: p.stat().st_mtime_ns for p in (REPO / "runtime").iterdir()
                   if p.name != "liblora_runtime.so"}      # the JAX binding's own build
    assert runtime.build(force=True) == tmp_path / "liblora_runtime.so"
    assert [p.name for p in tmp_path.iterdir()] == ["liblora_runtime.so"]
    ours_after = {p.name: p.stat().st_mtime_ns for p in (REPO / "runtime").iterdir()
                  if p.name != "liblora_runtime.so"}
    assert ours_after == ours_before


def test_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that fails makes the binding raise (no NumPy stand-in)."""
    monkeypatch.setattr(runtime, "LIBRARY", tmp_path / "liblora_runtime.so")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed to build"):
        runtime.build(force=True)
    assert not any(tmp_path.iterdir())                 # no half-written library


def test_cf32_roundtrip():
    rng = np.random.RandomState(0)
    inter = rng.randn(256).astype(np.float32)
    re, im = runtime.to_planar(inter)
    np.testing.assert_array_equal(re, inter[0::2])
    np.testing.assert_array_equal(im, inter[1::2])
    back = runtime.from_planar(re, im)
    np.testing.assert_array_equal(back, inter)


def test_int16_scaling():
    x = np.array([32767, -32768, 16384, 0], dtype=np.int16)
    re, im = runtime.to_planar(x, scale=1.0)
    np.testing.assert_allclose(re, [32767 / 32768.0, 0.5], atol=1e-6)
    np.testing.assert_allclose(im, [-1.0, 0.0], atol=1e-6)


def test_int8():
    x = np.array([127, -128, 64, 32], dtype=np.int8)
    re, im = runtime.to_planar(x, scale=1.0)
    np.testing.assert_allclose(re, [127 / 128.0, 0.5], atol=1e-6)
    np.testing.assert_allclose(im, [-1.0, 0.25], atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.int8])
def test_conversions_equal_jax_binding(dtype):
    """Every format converts to the same planes as the JAX package's
    binding of the same source."""
    from lora_phy_tpu import runtime as jrt

    rng = np.random.RandomState(5)
    if dtype == np.float32:
        x = rng.randn(1000).astype(np.float32)
    else:
        info = np.iinfo(dtype)
        x = rng.randint(info.min, info.max + 1, 1000).astype(dtype)
    for scale in (1.0, 0.37):
        a = runtime.to_planar(x, scale)
        b = jrt.to_planar(x, scale)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    re, im = runtime.to_planar(x)
    np.testing.assert_array_equal(runtime.from_planar(re, im), jrt.from_planar(re, im))


def test_ring_blocks_and_halo():
    ring = runtime.OverlapSaveRing(capacity=1024, block=128, halo=16)
    stream = np.arange(400, dtype=np.float32)
    pushed = ring.push(stream, -stream)
    assert pushed == 400
    assert ring.ready == 400

    re, im = ring.pop_block()
    np.testing.assert_array_equal(re[:16], np.zeros(16))
    np.testing.assert_array_equal(re[16:], stream[:128])
    np.testing.assert_array_equal(im[16:], -stream[:128])
    assert ring.position == 128

    re2, _ = ring.pop_block()
    np.testing.assert_array_equal(re2[:16], stream[112:128])
    np.testing.assert_array_equal(re2[16:], stream[128:256])

    re3, _ = ring.pop_block()
    np.testing.assert_array_equal(re3[16:], stream[256:384])
    assert ring.pop_block() is None


def test_ring_backpressure():
    ring = runtime.OverlapSaveRing(capacity=256, block=64, halo=8)
    big = np.zeros(1000, np.float32)
    pushed = ring.push(big, big)
    assert pushed == 256 - 8
    ring.pop_block()
    assert ring.space == 64


def test_ring_plane_length_mismatch():
    ring = runtime.OverlapSaveRing(capacity=256, block=64, halo=8)
    with pytest.raises(ValueError, match="plane length mismatch"):
        ring.push(np.zeros(10, np.float32), np.zeros(9, np.float32))


def test_ring_full_refill_across_wrap_keeps_halo():
    cap, block, halo = 256, 64, 8
    ring = runtime.OverlapSaveRing(capacity=cap, block=block, halo=halo)
    total = np.arange(4096, dtype=np.float32)
    fed = 0
    popped = 0
    while fed < total.size or ring.ready >= block:
        space = ring.space
        if space and fed < total.size:
            fed += ring.push(total[fed:fed + space], -total[fed:fed + space])
        blk = ring.pop_block()
        if blk is None:
            assert fed >= total.size
            break
        re, im = blk
        start = popped * block
        if popped > 0:
            np.testing.assert_array_equal(re[:halo], total[start - halo:start])
            np.testing.assert_array_equal(im[:halo], -total[start - halo:start])
        np.testing.assert_array_equal(re[halo:], total[start:start + block])
        popped += 1
    assert popped >= 60


def test_ring_wraparound_consistency():
    ring = runtime.OverlapSaveRing(capacity=300, block=100, halo=10)
    total = np.arange(1000, dtype=np.float32)
    fed = 0
    out = []
    while fed < 1000 or ring.ready >= 100:
        if fed < 1000:
            fed += ring.push(total[fed:fed + 50], total[fed:fed + 50])
        blk = ring.pop_block()
        if blk is not None:
            out.append(blk[0][10:])
    joined = np.concatenate(out)
    np.testing.assert_array_equal(joined, total[: len(joined)])
    assert len(joined) >= 900


def test_read_iq_file(tmp_path):
    from lora_phy_tpu_torch.utils.iqio import write_iq

    x = (np.arange(64) - 1j * np.arange(64)).astype(np.complex64)
    path = tmp_path / "x.iq"
    write_iq(path, x)
    re, im = runtime.read_iq_file(path)
    np.testing.assert_array_equal(re, x.real)
    np.testing.assert_array_equal(im, x.imag)
    re2, im2 = runtime.read_iq_file(path, offset_samples=10, n_samples=20)
    np.testing.assert_array_equal(re2, x.real[10:30])
    scaled = np.round(np.stack([x.real, x.imag], -1).reshape(-1) * 100).astype(np.int16)
    path16 = tmp_path / "x16.iq"
    scaled.tofile(path16)
    re3, im3 = runtime.read_iq_file(path16, fmt=runtime.FORMAT_CI16)
    np.testing.assert_array_equal((re3, im3), runtime.to_planar(scaled))


def test_streaming_demod_via_native_ring():
    """End-to-end: the native ring feeds planar blocks into the port's
    demod, which decodes what the JAX demod decodes from the same
    dechirped samples."""
    from lora_phy_tpu.models import modem as jmodem
    from lora_phy_tpu.utils.params import LoraParams
    from lora_phy_tpu_torch.models import modem
    from lora_phy_tpu_torch.ops import planar

    p = LoraParams(sf=7)
    payload = np.arange(16, dtype=np.uint8)
    iq = jmodem.modulate(jmodem.encode(payload), p)
    dech = np.asarray(jmodem.dechirp(iq, p))
    re, im = dech.real.astype(np.float32).copy(), dech.imag.astype(np.float32).copy()

    ring = runtime.OverlapSaveRing(capacity=re.size * 2, block=re.size, halo=p.step)
    ring.push(re, im)
    blk = ring.pop_block()
    assert blk is not None
    xr, xi = tt(blk[0][p.step:]), tt(blk[1][p.step:])
    res = planar.demodulate_planar(xr, xi, tparams(p))
    np.testing.assert_array_equal(nn(modem.decode(res.symbols)), payload)
    assert res.symbols.device == torch.device("cpu")
