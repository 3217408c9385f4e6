"""The planar dechirp: ``lora_phy_tpu_torch.ops.planar.dechirp_planar``
through ``ops/dechirp.py``.

On the CPU the wrapper runs its plain twin (the four products and two
sums as eager ops), which must equal the explicit formula over the tiled
downchirp bit for bit and launch nothing; the C interface of
``csrc/dechirp.cu`` is checked against the wrapper's ``ENTRY``. On the
card (``gpu``) the hand kernel must equal the twin bit for bit on the
same inputs, on an offset view (its scalar path) too, launch once a call
and run inside the ``planar.dechirp`` range.
"""

import ctypes
import re
import types

import pytest
import torch

from _torch_util import cuda_device
from lora_phy_tpu_torch import LoraParams, _build, device_table
from lora_phy_tpu_torch.ops import chirp, planar
from lora_phy_tpu_torch.ops import dechirp as tdechirp
from lora_phy_tpu_torch.utils import profiling

SHAPES = ("one_row", "batch", "batch_frames", "tail", "complex_views")


def planes(sf, osr, shape, seed, dev=torch.device("cpu")):
    """(xr, xi) float32 inputs of the named kind: one row, [B], [B, F]
    rows of whole symbol periods, [B] rows with a tail past the last
    whole period, or the .real / .imag views of a complex [B] tensor."""
    step = (1 << sf) * osr
    nsym = 3 if sf < 12 else 2
    gen = torch.Generator().manual_seed(seed)
    lead = {"one_row": (), "batch": (3,), "batch_frames": (2, 3), "tail": (3,),
            "complex_views": (3,)}[shape]
    length = nsym * step + (step // 2 + 3 if shape == "tail" else 0)
    if shape == "complex_views":
        iq = torch.randn(*lead, length, dtype=torch.complex64, generator=gen).to(dev)
        return iq.real, iq.imag
    x = torch.randn(2, *lead, length, generator=gen).to(dev)
    return x[0], x[1]


def explicit(xr, xi, p):
    """xr * dr - xi * di and xr * di + xi * dr over the downchirp tiled to
    the whole symbol periods of the row."""
    dr, di = (torch.from_numpy(t) for t in chirp.base_downchirp_planar(p.sf, p.scale, p.osr))
    nsym = xr.shape[-1] // p.step
    dr, di = dr.repeat(nsym).to(xr.device), di.repeat(nsym).to(xr.device)
    ar, ai = xr[..., : nsym * p.step], xi[..., : nsym * p.step]
    return ar * dr - ai * di, ar * di + ai * dr


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("osr", [1, 2])
@pytest.mark.parametrize("sf", [5, 7, 12])
def test_dechirp_planar_equals_the_explicit_formula(sf, osr, shape):
    p = LoraParams(sf=sf, osr=osr)
    xr, xi = planes(sf, osr, shape, seed=100 * sf + 10 * osr + SHAPES.index(shape))
    launches = tdechirp.LAUNCHES
    yr, yi = planar.dechirp_planar(xr, xi, p)
    assert tdechirp.LAUNCHES == launches
    wr, wi = explicit(xr, xi, p)
    assert yr.shape == yi.shape == xr.shape[:-1] + (xr.shape[-1] // p.step * p.step,)
    assert yr.dtype == yi.dtype == torch.float32
    assert torch.equal(yr, wr) and torch.equal(yi, wi)


def test_dechirp_leaves_its_inputs_and_refuses_other_devices():
    p = LoraParams(sf=7)
    xr, xi = planes(7, 1, "tail", seed=1)
    before = xr.clone(), xi.clone()
    planar.dechirp_planar(xr, xi, p)
    assert torch.equal(xr, before[0]) and torch.equal(xi, before[1])
    meta = torch.empty(2, p.step, device="meta")
    d = torch.empty(p.step, device="meta")
    with pytest.raises(ValueError, match="no dechirp kernel"):
        tdechirp.dechirp(meta, meta, d, d)


def c_parameters(source: str, name: str):
    """The parameter types of ``extern "C" int name(...)`` in ``source``."""
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', source)
    assert m, f"{name} is not declared extern \"C\""
    return [re.sub(r"\s*\w+$", "", a.strip()) for a in m.group(1).split(",")]


def test_kernel_source_is_built_and_declared():
    src = next(s for s in _build.SOURCES if s.name == "dechirp.cu")
    assert src.is_file()
    fake = types.SimpleNamespace(lora_dechirp=lambda *a: 0)
    _build.declare(fake, tdechirp.ENTRY)
    argtypes = fake.lora_dechirp.argtypes
    params = c_parameters(src.read_text(), "lora_dechirp")
    assert len(argtypes) == len(params) == 14
    for ctype, decl in zip(argtypes, params):
        if "*" in decl:
            assert ctype is ctypes.c_void_p, decl
        else:
            assert decl == "long long" and ctype is ctypes.c_longlong, decl
    assert fake.lora_dechirp.restype is ctypes.c_int


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("osr", [1, 2])
@pytest.mark.parametrize("sf", [5, 7, 12])
def test_cuda_kernel_equals_twin(sf, osr, shape):
    """On the card: the kernel's planes equal the eager twin's on the same
    device tensors and the CPU twin's, bit for bit; one launch a call; an
    offset view (base off a 16-byte boundary, row stride odd) takes the
    scalar path with the same result; the inputs are left as they were."""
    dev = cuda_device()
    p = LoraParams(sf=sf, osr=osr)
    xr, xi = planes(sf, osr, shape, seed=100 * sf + 10 * osr + SHAPES.index(shape), dev=dev)
    before = xr.clone(), xi.clone()
    launches = tdechirp.LAUNCHES
    yr, yi = planar.dechirp_planar(xr, xi, p)
    assert tdechirp.LAUNCHES == launches + 1
    dr, di = device_table(chirp.base_downchirp_planar, p.sf, p.scale, p.osr, device=dev)
    wr, wi = tdechirp.dechirp_reference(xr, xi, dr, di)
    assert torch.equal(yr, wr) and torch.equal(yi, wi)
    cr, ci = planar.dechirp_planar(xr.cpu(), xi.cpu(), p)
    assert torch.equal(yr.cpu(), cr) and torch.equal(yi.cpu(), ci)
    assert torch.equal(xr, before[0]) and torch.equal(xi, before[1])

    length = xr.shape[-1]
    wide = torch.zeros(2, *xr.shape[:-1], length + 1 + length % 2, device=dev)
    wide[0, ..., 1:length + 1], wide[1, ..., 1:length + 1] = xr, xi
    off_r, off_i = wide[0, ..., 1:length + 1], wide[1, ..., 1:length + 1]
    assert off_r.data_ptr() % 16 and off_r.stride(-2 if off_r.dim() > 1 else -1) % 2
    launches = tdechirp.LAUNCHES
    orr, oi = planar.dechirp_planar(off_r, off_i, p)
    assert tdechirp.LAUNCHES == launches + 1
    assert torch.equal(orr, wr) and torch.equal(oi, wi)


@pytest.mark.gpu
def test_cuda_kernel_runs_in_the_dechirp_range():
    """Traced (``utils/profiling.range_profile``, the attribution the
    harness froze), the kernel's device time is linked under
    planar.dechirp, and no device time falls outside the range."""
    dev = cuda_device()
    p = LoraParams(sf=7)
    xr, xi = planes(7, 1, "batch_frames", seed=5, dev=dev)
    prof = profiling.range_profile(lambda: planar.dechirp_planar(xr, xi, p),
                                   ("planar.dechirp",), calls=2)
    kernel_ms = sum(ms for name, ms in prof.kernels.items() if "dechirp" in name)
    stage_ms, _, events = prof.stages["planar.dechirp"]
    assert kernel_ms > 0 and events == 1, prof.kernels
    assert stage_ms == pytest.approx(kernel_ms) and prof.other[2] == 0, prof
