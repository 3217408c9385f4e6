"""The shifted symbol windows: ``lora_phy_tpu_torch.ops.windows``, the
guarded per-symbol timing shift of both planes that the demodulators'
front runs in ``planar.windows``.

On the CPU the plain twin (a padded copy, an index gather and a select a
plane) must equal the JAX package's ``_shifted_symbol_gather`` bit for
bit on both planes: at osr 1 and 2 with every decimation phase, offsets of
0, +-1, +-(step - 1), +-step and beyond one symbol, all zero, a row with a
tail past the last whole symbol, and offset or strided views. The wrapper
routes a CPU tensor to the twin, returns views where every offset is zero
and refuses a plane that is not float32 or not the other's shape; the C
interface of ``csrc/windows.cu`` is checked against the wrapper's
``ENTRY``. On the card (``gpu``) the hand kernel must equal the twin bit
for bit on the same grid and at a bulk-like shape, launch once a shifted
call and never an aligned one, and run inside the ``planar.windows``
range.
"""

import ctypes
import re
import types

import numpy as np
import pytest
import torch

from _torch_util import cuda_device, nn, tt
from lora_phy_tpu.models import modem as jmodem
from lora_phy_tpu_torch import _build
from lora_phy_tpu_torch.ops import windows
from lora_phy_tpu_torch.utils import profiling

N, S, ROWS, TAIL = 32, 5, 6, 7
PHASES = [(1, 0), (2, 0), (2, 1)]
OFFSETS = ("one", "edge", "step", "beyond", "mixed", "zero")
VIEWS = ("contiguous", "offset", "complex")


def offsets(kind: str, step: int) -> np.ndarray:
    """[ROWS] int32 timing offsets of the named kind."""
    table = {
        "one": [1, -1, 0, 1, -1, 0],
        "edge": [step - 1, -(step - 1), step - 1, 0, -(step - 1), 1],
        "step": [step, -step, step, -step, 0, step],
        # beyond one symbol: only known_offsets reaches these
        "beyond": [step + 5, -(step + 5), 3 * step, -3 * step, 2 * step + 1, -(S * step)],
        "mixed": [0, 37 % step, -45 % step - step, 3, -(step + 2), step // 2],
        "zero": [0] * ROWS,
    }
    return np.array(table[kind], np.int32)


def planes(osr: int, view: str, seed: int, dev=torch.device("cpu")):
    """(xr, xi) float32 [ROWS, S*step + TAIL] planes: contiguous, a view
    whose base is one sample into wider rows (odd row stride), or the
    .real / .imag views of a complex tensor (element stride 2); and the
    same values as numpy arrays."""
    length = S * N * osr + TAIL
    gen = torch.Generator().manual_seed(seed)
    if view == "complex":
        iq = torch.randn(ROWS, length, dtype=torch.complex64, generator=gen).to(dev)
        xr, xi = iq.real, iq.imag
    elif view == "offset":
        wide = torch.randn(2, ROWS, length + 2, generator=gen).to(dev)
        xr, xi = wide[0, :, 1:length + 1], wide[1, :, 1:length + 1]
    else:
        x = torch.randn(2, ROWS, length, generator=gen).to(dev)
        xr, xi = x[0], x[1]
    return xr, xi, xr.cpu().numpy().copy(), xi.cpu().numpy().copy()


@pytest.mark.parametrize("view", VIEWS)
@pytest.mark.parametrize("kind", OFFSETS)
@pytest.mark.parametrize("osr,dec_phase", PHASES)
def test_twin_equals_jax(osr, dec_phase, kind, view):
    step = N * osr
    xr, xi, ar, ai = planes(osr, view, seed=10 * osr + dec_phase + 100 * OFFSETS.index(kind))
    t_off = offsets(kind, step)
    yr, yi = windows.shifted_windows_reference(xr, xi, S, N, osr, tt(t_off), dec_phase)
    assert yr.shape == yi.shape == (ROWS, S, N) and yr.dtype == torch.float32
    np.testing.assert_array_equal(nn(yr), nn(jmodem._shifted_symbol_gather(
        ar, S, N, osr, t_off, dec_phase)))
    np.testing.assert_array_equal(nn(yi), nn(jmodem._shifted_symbol_gather(
        ai, S, N, osr, t_off, dec_phase)))


@pytest.mark.parametrize("kind", OFFSETS)
@pytest.mark.parametrize("osr,dec_phase", PHASES)
def test_wrapper_routes_cpu_to_the_twin(osr, dec_phase, kind):
    """On the CPU the wrapper launches nothing: it gives the twin's planes,
    and views of the inputs (counted in ALIGNED) where every offset is 0;
    the inputs are left as they were."""
    step = N * osr
    xr, xi, _, _ = planes(osr, "offset", seed=7 * osr + dec_phase)
    before = xr.clone(), xi.clone()
    t_off = tt(offsets(kind, step))
    launches, aligned = windows.LAUNCHES, windows.ALIGNED
    syncs = profiling.HOST_SYNCS
    yr, yi = windows.shifted_windows(xr, xi, S, N, osr, t_off, dec_phase)
    assert windows.LAUNCHES == launches
    assert profiling.HOST_SYNCS == syncs + 1
    assert windows.ALIGNED == aligned + (kind == "zero")
    if kind == "zero":
        assert yr.data_ptr() == xr.data_ptr() + 4 * dec_phase
        assert yi.data_ptr() == xi.data_ptr() + 4 * dec_phase
    wr, wi = windows.shifted_windows_reference(xr, xi, S, N, osr, t_off, dec_phase)
    assert torch.equal(yr, wr) and torch.equal(yi, wi)
    assert torch.equal(xr, before[0]) and torch.equal(xi, before[1])


def test_wrapper_broadcasts_one_offset_over_the_rows():
    xr, xi, _, _ = planes(1, "contiguous", seed=3)
    t = torch.tensor(5, dtype=torch.int32)
    yr, yi = windows.shifted_windows(xr, xi, S, N, 1, t)
    wr, wi = windows.shifted_windows_reference(xr, xi, S, N, 1, torch.full((ROWS,), 5))
    assert torch.equal(yr, wr) and torch.equal(yi, wi)


def test_wrapper_refuses_other_planes():
    xr, xi, _, _ = planes(1, "contiguous", seed=4)
    t_off = tt(offsets("one", N))
    with pytest.raises(TypeError, match="xi must be float32"):
        windows.shifted_windows(xr, xi.double(), S, N, 1, t_off)
    with pytest.raises(TypeError, match="xr must be float32"):
        windows.shifted_windows(xr.half(), xi, S, N, 1, t_off)
    with pytest.raises(ValueError, match="xi is"):
        windows.shifted_windows(xr, xi[:, 1:], S, N, 1, t_off)
    with pytest.raises(ValueError, match="xi is"):
        windows.shifted_windows(xr, xi[:4], S, N, 1, t_off)
    meta = torch.empty(ROWS, S * N, device="meta")
    with pytest.raises(ValueError, match="no windows kernel"):
        windows.shifted_windows_kernel(meta, meta, S, N, 1, t_off)


def c_parameters(source: str, name: str):
    """The parameter types of ``extern "C" int name(...)`` in ``source``."""
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', source)
    assert m, f"{name} is not declared extern \"C\""
    return [re.sub(r"\s*\w+$", "", a.strip()) for a in m.group(1).split(",")]


def test_kernel_source_is_built_and_declared():
    src = next(s for s in _build.SOURCES if s.name == "windows.cu")
    assert src.is_file()
    fake = types.SimpleNamespace(lora_windows=lambda *a: 0)
    _build.declare(fake, windows.ENTRY)
    argtypes = fake.lora_windows.argtypes
    params = c_parameters(src.read_text(), "lora_windows")
    assert len(argtypes) == len(params) == 15
    for ctype, decl in zip(argtypes, params):
        if "*" in decl:
            assert ctype is ctypes.c_void_p, decl
        else:
            assert decl == "long long" and ctype is ctypes.c_longlong, decl
    assert fake.lora_windows.restype is ctypes.c_int


@pytest.mark.gpu
@pytest.mark.parametrize("view", VIEWS)
@pytest.mark.parametrize("kind", OFFSETS)
@pytest.mark.parametrize("osr,dec_phase", PHASES)
def test_cuda_kernel_equals_twin(osr, dec_phase, kind, view):
    """On the card: the wrapper's planes equal the twin's on the same
    device tensors and the CPU twin's, bit for bit; one launch a shifted
    call, none an aligned one (counted in ALIGNED); the inputs are left as
    they were."""
    dev = cuda_device()
    step = N * osr
    xr, xi, _, _ = planes(osr, view, seed=10 * osr + dec_phase + 100 * OFFSETS.index(kind),
                          dev=dev)
    before = xr.clone(), xi.clone()
    t_off = tt(offsets(kind, step)).to(dev)
    launches, aligned = windows.LAUNCHES, windows.ALIGNED
    yr, yi = windows.shifted_windows(xr, xi, S, N, osr, t_off, dec_phase)
    assert windows.LAUNCHES == launches + (kind != "zero")
    assert windows.ALIGNED == aligned + (kind == "zero")
    wr, wi = windows.shifted_windows_reference(xr, xi, S, N, osr, t_off, dec_phase)
    assert torch.equal(yr, wr) and torch.equal(yi, wi)
    cr, ci = windows.shifted_windows_reference(xr.cpu(), xi.cpu(), S, N, osr, t_off.cpu(),
                                               dec_phase)
    assert torch.equal(yr.cpu(), cr) and torch.equal(yi.cpu(), ci)
    kr, ki = windows.shifted_windows_kernel(xr, xi, S, N, osr, t_off, dec_phase)
    assert kr.is_contiguous() and torch.equal(kr, wr) and torch.equal(ki, wi)
    assert torch.equal(xr, before[0]) and torch.equal(xi, before[1])


@pytest.mark.gpu
def test_cuda_kernel_at_a_bulk_like_shape():
    """[8, 1024] SF7 frames of 52 symbols (the bulk cell's rows, an eighth
    of its frames), offsets drawn over +-(step - 1) and a few beyond:
    bit-equal to the twin."""
    dev = cuda_device()
    n, s = 128, 52
    gen = torch.Generator(device=dev).manual_seed(23)
    xr = torch.randn(8, 1024, s * n, generator=gen, device=dev)
    xi = torch.randn(8, 1024, s * n, generator=gen, device=dev)
    t_off = torch.randint(-(n - 1), n, (8, 1024), generator=gen, device=dev,
                          dtype=torch.int32)
    t_off[0, :4] = torch.tensor([n, -n, 3 * n, -5 * n], dtype=torch.int32)
    launches = windows.LAUNCHES
    yr, yi = windows.shifted_windows(xr, xi, s, n, 1, t_off)
    assert windows.LAUNCHES == launches + 1
    wr, wi = windows.shifted_windows_reference(xr, xi, s, n, 1, t_off)
    assert torch.equal(yr, wr) and torch.equal(yi, wi)


@pytest.mark.gpu
def test_cuda_kernel_runs_in_the_windows_range():
    """Traced (``utils/profiling.range_profile``, the attribution the
    harness froze), the kernel's device time is linked under
    planar.windows, and no device time falls outside the range."""
    dev = cuda_device()
    xr, xi, _, _ = planes(1, "contiguous", seed=5, dev=dev)
    t_off = tt(offsets("mixed", N)).to(dev)

    def call():
        with profiling.stage_range("planar.windows"):
            windows.shifted_windows(xr, xi, S, N, 1, t_off)

    prof = profiling.range_profile(call, ("planar.windows",), calls=2)
    kernel_ms = sum(ms for name, ms in prof.kernels.items() if "shifted_windows" in name)
    assert kernel_ms > 0, prof.kernels
    assert prof.other[2] == 0, prof
