"""The demodulator's per-symbol stage on the exact float32 route above
N = 128: ``lora_phy_tpu_torch.ops.decide`` under
``ops.planar.demodulate_planar(fused=False)``.

On the CPU, and at N <= 128 on any device, the wrapper runs its plain twin
``decide_reference``, which must equal the stage's ops as they stood before
the kernel (the rotation planes, the derotated planes, the planar DFT's
argmax) bit for bit and launch nothing. The kernel's FFT is emulated in
numpy (``_fft_emulation``) on the twin's derotated planes and must give the
twin's bins outside near-ties; the C interface of ``csrc/decide.cu`` is
checked against the wrapper's ``ENTRY``, and its headers against the
rebuild check. On the card (``gpu``) the kernel is held to the twin on the
same device tensors, one launch a call, inside the ``planar.decide`` range.
"""

import ctypes
import json
import os
import pathlib
import re
import types

import numpy as np
import pytest
import torch

from _fft_emulation import kernel_power
from _torch_util import cuda_device
from lora_phy_tpu_torch import LoraParams, _build
from lora_phy_tpu_torch.models import coded
from lora_phy_tpu_torch.ops import bf16_decide, fused_demod, planar
from lora_phy_tpu_torch.ops import decide as tdecide
from lora_phy_tpu_torch.utils import profiling
from lora_phy_tpu_torch.utils.params import Window
from phybench.traffic import generator

# the kernel's bins against the twin's: equal wherever the twin's two
# largest powers of a row differ by more than this share of the larger
NEAR_TIE = 1e-5
LEADS = {"B": (3,), "BC": (2, 2)}
BENCH = pathlib.Path(__file__).resolve().parents[1] / "phybench"


def rows(sf, lead, symbols, seed, osr=1, dev=torch.device("cpu")):
    """``(yr, yi, rate, scale)``: [*lead, S, N] window planes of tones at
    random bins under noise, read at decimation phase ``osr - 1`` of
    [*lead, S * N * osr] planes (strided views at osr > 1), and a
    rate (a CFO within +-0.5 bin) and an amplitude scale per frame."""
    n = 1 << sf
    gen = torch.Generator().manual_seed(seed)
    bins = torch.randint(0, n, (*lead, symbols, 1), generator=gen)
    i = torch.arange(n * osr).reshape(n, osr)[:, 0].to(torch.float64)
    ph = 2 * np.pi * bins.to(torch.float64) * i / n
    noise = torch.randn(2, *lead, symbols, n * osr, generator=gen, dtype=torch.float64)
    xr = (torch.cos(ph).repeat_interleave(osr, -1) + 0.8 * noise[0]).to(torch.float32)
    xi = (torch.sin(ph).repeat_interleave(osr, -1) + 0.8 * noise[1]).to(torch.float32)
    xr = xr.reshape(*lead, symbols * n * osr).to(dev)
    xi = xi.reshape(*lead, symbols * n * osr).to(dev)

    def view(x):
        return x.reshape(*lead, symbols, n, osr)[..., osr - 1]

    rate = ((torch.rand(lead, generator=gen) - 0.5) * (2 * np.pi / n)).to(torch.float32)
    scale = (0.25 + torch.rand(lead, generator=gen)).to(torch.float32)
    return view(xr), view(xi), rate.to(dev), scale.to(dev)


def pre_change(yr, yi, rate, scale, p):
    """The stage's ops as ``demodulate_planar(fused=False)`` ran them before
    the kernel (``_rotated_windows_planar``, then ``argmax_bins_planar``),
    written out here."""
    n = p.n
    phi = rate[..., None] * torch.arange(n, dtype=torch.float32, device=rate.device)
    cr, si = torch.cos(phi), torch.sin(phi)
    if scale is not None:
        cr = cr * scale[..., None]
        si = si * scale[..., None]
    window = planar._window_tensor(p, rate.device)
    if window is not None:
        cr, si = cr * window, si * window
    cr, si = cr[..., None, :], si[..., None, :]
    return planar.argmax_bins_planar(yr * cr - yi * si, yr * si + yi * cr, n)


@pytest.mark.parametrize("window", [Window.NONE, Window.HANN], ids=["none", "hann"])
@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "scaled"])
@pytest.mark.parametrize("sf", [8, 9, 10, 11, 12])
def test_twin_equals_the_pre_change_ops(sf, scaled, window):
    p = LoraParams(sf=sf, window=window)
    lead = LEADS["BC" if sf % 2 else "B"]
    yr, yi, rate, scale = rows(sf, lead, 4, seed=10 * sf + scaled, osr=1 + sf % 2)
    scale = scale if scaled else None
    got = tdecide.decide_reference(yr, yi, rate, scale, p)
    want = pre_change(yr, yi, rate, scale, p)
    assert got.dtype == torch.int32 and got.shape == (*lead, 4)
    assert torch.equal(got, want)


def test_wrapper_runs_the_twin_on_the_cpu():
    """On a CPU tensor the wrapper is the twin and launches nothing, also
    under demodulate_planar(fused=False), whose symbols are the pre-change
    ops' bins after its own front."""
    p = LoraParams(sf=9)
    yr, yi, rate, scale = rows(9, (2,), 6, seed=3)
    launches = tdecide.LAUNCHES
    got = tdecide.decide_rows(yr, yi, rate, scale, p)
    assert torch.equal(got, tdecide.decide_reference(yr, yi, rate, scale, p))
    xr, xi = yr.reshape(2, -1), yi.reshape(2, -1)
    res = planar.demodulate_planar(xr, xi, p, fused=False)
    front = planar._demod_stage_planar(xr, xi, p, False, None)
    want = pre_change(front[0], front[1], front[2], front[4], p)
    assert torch.equal(res.symbols, want[..., 2:])
    assert tdecide.LAUNCHES == launches


def meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_wrapper_runs_the_twin_at_n_up_to_128():
    """At N <= 128 the wrapper is the twin on any device (a meta tensor
    here: the twin's ops run, no launch is tried); at N = 256 the same
    call goes to the launch, which refuses a device that is not CUDA."""
    launches = tdecide.LAUNCHES
    got = tdecide.decide_rows(meta(2, 5, 128), meta(2, 5, 128), meta(2), meta(2),
                              LoraParams(sf=7))
    assert got.shape == (2, 5) and got.dtype == torch.int32
    with pytest.raises(ValueError, match="^no decide kernel for device meta$"):
        tdecide.decide_rows(meta(2, 5, 256), meta(2, 5, 256), meta(2), meta(2),
                            LoraParams(sf=8))
    assert tdecide.LAUNCHES == launches


SF8 = LoraParams(sf=8)
# (what is wrong, the call's arguments, the error, its message)
BAD_CALLS = {
    "yr_dtype": ((meta(2, 4, 256, dtype=torch.float64), meta(2, 4, 256), meta(2), None, SF8),
                 TypeError, "yr must be float32"),
    "rate_dtype": ((meta(2, 4, 256), meta(2, 4, 256), meta(2, dtype=torch.float16), None, SF8),
                   TypeError, "rate must be float32"),
    "scale_dtype": ((meta(2, 4, 256), meta(2, 4, 256), meta(2), meta(2, dtype=torch.int32),
                     SF8), TypeError, "scale must be float32"),
    "device": ((meta(2, 4, 256), torch.empty(2, 4, 256), meta(2), None, SF8), ValueError,
               "yi is on cpu"),
    "shapes": ((meta(2, 4, 256), meta(2, 5, 256), meta(2), None, SF8), ValueError,
               r"one shape, got \(2, 4, 256\) and \(2, 5, 256\)"),
    "n": ((meta(2, 4, 512), meta(2, 4, 512), meta(2), None, SF8), ValueError,
          r"\[\.\.\., S, 256\] planes"),
    "rows": ((meta(256), meta(256), meta(()), None, SF8), ValueError, r"\[\.\.\., S, 256\]"),
    "rate_shape": ((meta(2, 4, 256), meta(2, 4, 256), meta(3), None, SF8), ValueError,
                   r"rate has shape \(3,\)"),
    "scale_shape": ((meta(2, 4, 256), meta(2, 4, 256), meta(2), meta(2, 4), SF8), ValueError,
                    r"scale has shape \(2, 4\)"),
    "n_range": ((meta(1, 2, 8192), meta(1, 2, 8192), meta(1), None,
                 types.SimpleNamespace(n=8192)), ValueError, "no decide kernel for n=8192"),
}


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    args, error, message = BAD_CALLS[case]
    launches = tdecide.LAUNCHES
    with pytest.raises(error, match=message):
        tdecide.decide_rows(*args)
    assert tdecide.LAUNCHES == launches


def c_parameters(source: str, name: str):
    """The parameter types of ``extern "C" int name(...)`` in ``source``."""
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', source)
    assert m, f"{name} is not declared extern \"C\""
    return [re.sub(r"\s*\w+$", "", a.strip()) for a in m.group(1).split(",")]


def test_kernel_source_is_built_and_declared():
    src = next(s for s in _build.SOURCES if s.name == "decide.cu")
    assert src.is_file()
    fake = types.SimpleNamespace(lora_decide=lambda *a: 0)
    _build.declare(fake, tdecide.ENTRY)
    argtypes = fake.lora_decide.argtypes
    params = c_parameters(src.read_text(), "lora_decide")
    assert len(argtypes) == len(params) == 17
    want = {ctypes.c_longlong: "long long", ctypes.c_int: "int"}
    for ctype, decl in zip(argtypes, params):
        if "*" in decl:
            assert ctype is ctypes.c_void_p, decl
        else:
            assert decl == want[ctype], decl
    assert fake.lora_decide.restype is ctypes.c_int


@pytest.mark.parametrize("header", ["fft_rows.cuh", "fft_block.cuh"])
def test_its_headers_rebuild_the_library(header, tmp_path, monkeypatch):
    """decide.cu includes both FFT headers, which are in _build.HEADERS: a
    header newer than the library rebuilds it from every source, one
    older does not."""
    src = next(s for s in _build.SOURCES if s.name == "decide.cu")
    assert header in re.findall(r'#include "([^"]+)"', src.read_text())
    path = next(h for h in _build.HEADERS if h.name == header)
    library = tmp_path / "lib.so"
    library.write_bytes(b"")
    built = []
    monkeypatch.setattr(_build, "LIBRARY", library)
    monkeypatch.setattr(_build, "compile_library",
                        lambda sources, lib, verbose=False: built.append(tuple(sources)) or lib)
    newest = max(s.stat().st_mtime for s in (*_build.SOURCES, *_build.HEADERS))
    os.utime(library, (newest + 10, newest + 10))
    _build.build()
    assert built == []
    os.utime(library, (path.stat().st_mtime - 10, path.stat().st_mtime - 10))
    _build.build()
    assert built == [tuple(_build.SOURCES)]


# ---------------------------------------------------------------------------
# The kernel's FFT, emulated in numpy float32 stage for stage (_fft_emulation)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sf", [8, 9, 10, 11, 12])
def test_kernel_fft_emulation_matches_twin(sf):
    """On the twin's derotated planes (the kernel's, up to the FFT) the
    kernel's FFT (emulated) gives the twin's bins except where the twin's
    two largest powers lie within NEAR_TIE of each other; on a tone at
    every 37th bin, that bin."""
    p = LoraParams(sf=sf, window=Window.HANN if sf % 2 else Window.NONE)
    symbols = max(8, (1 << 15) >> sf)
    yr, yi, rate, scale = rows(sf, (2,), symbols, seed=700 + sf)
    fr, fi = tdecide._rotated_windows_planar(yr, yi, rate, None, scale, p)
    want = tdecide.decide_reference(yr, yi, rate, scale, p).reshape(-1).numpy()
    mag = kernel_power(fr.reshape(-1, p.n).numpy(), fi.reshape(-1, p.n).numpy())
    got = np.argmax(mag, axis=-1)
    top2 = planar.dft_mag2_planar(fr, fi, p.n).reshape(-1, p.n).topk(2, dim=-1).values.numpy()
    near = (top2[:, 0] - top2[:, 1]) <= NEAR_TIE * top2[:, 0]
    assert near.mean() < 0.01
    assert (got[~near] == want[~near]).all(), np.flatnonzero((got != want) & ~near)
    n = p.n
    k = np.arange(0, n, 37)
    ang = 2 * np.pi * np.outer(k, np.arange(n)) / n            # row r: a tone at bin k[r]
    mag = kernel_power(np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))
    assert (np.argmax(mag, axis=-1) == k).all()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def compare(yr, yi, rate, scale, p):
    """The kernel against the twin on the same device planes: (rows,
    near-ties, mismatches outside them)."""
    got = tdecide.decide_rows(yr, yi, rate, scale, p)
    want = tdecide.decide_reference(yr, yi, rate, scale, p)
    fr, fi = tdecide._rotated_windows_planar(yr, yi, rate, None, scale, p)
    top2 = planar.dft_mag2_planar(fr, fi, p.n).topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= NEAR_TIE * top2[..., 0]
    assert got.shape == want.shape == yr.shape[:-1] and got.dtype == torch.int32
    return near.numel(), int(near.sum()), int(((got != want) & ~near).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("window", [Window.NONE, Window.HANN], ids=["none", "hann"])
@pytest.mark.parametrize("osr", [1, 2])
@pytest.mark.parametrize("sf", [8, 9, 10, 11, 12])
def test_cuda_kernel_against_twin(sf, osr, window):
    """Tones under noise in [37, S] frames (a count no tile divides; osr 2
    as strided views), with and without the scale, and a complex tensor's
    .real / .imag views: bins equal to the twin's outside near-ties, one
    launch a call, the planes left as they were."""
    dev = cuda_device()
    p = LoraParams(sf=sf, window=window)
    symbols = max(5, (1 << 17) >> sf) // 37 + 3
    yr, yi, rate, scale = rows(sf, (37,), symbols, seed=900 + 10 * sf + osr, osr=osr, dev=dev)
    before = yr.clone(), yi.clone()
    for s in (scale, None):
        launches = tdecide.LAUNCHES
        total, near, bad = compare(yr, yi, rate, s, p)
        assert tdecide.LAUNCHES == launches + 1
        assert bad == 0 and near <= 0.01 * total, (total, near, bad)
    assert torch.equal(yr, before[0]) and torch.equal(yi, before[1])
    iq = torch.complex(yr[:7].contiguous(), yi[:7].contiguous())
    total, near, bad = compare(iq.real, iq.imag, rate[:7], scale[:7], p)
    assert bad == 0, (total, near, bad)


def bulk_sf12(dev, batch=(2, 8), seed=2 ** 33 + 27):
    """Frames of the SF12 bulk cell's traffic (``bulk-sf12-b3328``) and its
    configuration: (config, item)."""
    cfg = json.loads((BENCH / "configs" / "bulk-sf12-bw500-cr45.json").read_text())
    traffic = dict(json.loads((BENCH / "traffic" / "bulk-sf12-b3328.json").read_text()),
                   batch=list(batch), pool=1)
    return cfg, generator.make_pool(cfg, traffic, seed, dev)[0]


@pytest.mark.gpu
def test_cuda_bulk_sf12_call_launches_the_kernel_once():
    """demodulate_planar(fused=False) on the SF12 bulk cell's frames: one
    decide launch a call and none of fused_demod or bf16_decide; symbols,
    sync words and the decoded bytes equal those of the twin's route."""
    dev = cuda_device()
    cfg, item = bulk_sf12(dev)
    p = LoraParams(sf=12, sync_word=cfg["sync_word"])
    ccfg = coded.CodedConfig(sf=12, cr=cfg["cr"], crc=cfg["crc"], whiten=cfg["whiten"])

    def call():
        dr, di = planar.dechirp_planar(item.xr, item.xi, p)
        res = planar.demodulate_planar(dr, di, p, fused=False)
        return res, coded.decode_payload(res.symbols, cfg["payload_bytes"], ccfg)

    counts = tdecide.LAUNCHES, fused_demod.LAUNCHES, bf16_decide.LAUNCHES
    res, (payload, crc_ok, _) = call()
    assert (tdecide.LAUNCHES, fused_demod.LAUNCHES, bf16_decide.LAUNCHES) == (
        counts[0] + 1, counts[1], counts[2])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(planar, "decide_rows", tdecide.decide_reference)
        res_t, (payload_t, crc_t, _) = call()
    assert tdecide.LAUNCHES == counts[0] + 1
    assert torch.equal(res.symbols, res_t.symbols)
    assert torch.equal(res.sync_word, res_t.sync_word)
    assert torch.equal(payload, payload_t) and torch.equal(crc_ok, crc_t)
    assert bool(crc_ok.float().mean() > 0.5)


@pytest.mark.gpu
def test_cuda_kernel_runs_in_the_decide_range():
    """Traced (``utils/profiling.range_profile``, the attribution the
    harness froze), the SF12 bulk call's per-symbol stage: the kernel's
    device time is linked under ``planar.decide``, once a call, and is
    the range's one device event."""
    dev = cuda_device()
    cfg, item = bulk_sf12(dev, seed=2 ** 31 + 5)
    p = LoraParams(sf=12, sync_word=cfg["sync_word"])
    dr, di = planar.dechirp_planar(item.xr, item.xi, p)
    ranges = ("planar.scale", "planar.estimate", "planar.windows", "planar.decide")
    prof = profiling.range_profile(lambda: planar.demodulate_planar(dr, di, p), ranges,
                                   calls=2)
    kernel = {name: ms for name, ms in prof.kernels.items()
              if re.search(r"\bdecide_block_kernel<", name)}
    assert len(kernel) == 1 and sum(kernel.values()) > 0, prof.kernels
    decide_ms, _, events = prof.stages["planar.decide"]
    assert decide_ms == pytest.approx(sum(kernel.values())) and events == 1, prof
