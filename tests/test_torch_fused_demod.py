"""Port parity: lora_phy_tpu_torch.ops.fused_demod against the Pallas
kernel's wrapper lora_phy_tpu.ops.pallas_demod.fused_detect_rows (which
runs in interpret mode on the CPU), mirroring tests/test_pallas.py.

On CPU tensors the port's wrapper runs the kernel's plain PyTorch twin;
the CUDA kernel itself is checked against that twin only where a card
is present (marked ``gpu``). The kernel's FFT (stage order, twiddle
table, bit-reversed index map) is checked here through a numpy emulation
of it (:func:`_kernel_emulation`)."""

import numpy as np
import pytest
import torch

from _torch_util import cuda_device, nn, tt, tparams
from lora_phy_tpu.models import modem as jmodem
from lora_phy_tpu.ops import pallas_demod as jfused
from lora_phy_tpu.ops import planar as jplanar
from lora_phy_tpu.utils.params import LoraParams, Window
from lora_phy_tpu_torch.models import modem as tmodem
from lora_phy_tpu_torch.ops import fused_demod as tfused
from lora_phy_tpu_torch.ops import planar as tplanar


def _case(p, payload_len=16, batch=None, seed=0):
    """Numpy-seeded payloads and their dechirped planes (JAX TX chain)."""
    rng = np.random.RandomState(seed)
    shape = (batch, payload_len) if batch else (payload_len,)
    payloads = rng.randint(0, 256, shape).astype(np.uint8)
    dech = np.asarray(jmodem.dechirp(jmodem.modulate(jmodem.encode(payloads), p), p))
    xr, xi = jplanar.split_complex(dech)
    return payloads, xr, xi


def _random_rows(p, b, seed):
    rng = np.random.RandomState(seed)
    xr = rng.randn(b, p.n).astype(np.float32)
    xi = rng.randn(b, p.n).astype(np.float32)
    start = rng.uniform(-300.0, 300.0, b).astype(np.float32)
    rate = rng.uniform(-0.5, 0.5, b).astype(np.float32)
    return xr, xi, start, rate


@pytest.mark.parametrize("sf", [5, 7])
def test_fused_matches_unfused(sf):
    p = LoraParams(sf=sf)
    tp = tparams(p)
    _, xr, xi = _case(p)
    ref = tplanar.demodulate_planar(tt(xr), tt(xi), tp, fused=False)
    got = tplanar.demodulate_planar(tt(xr), tt(xi), tp, fused=True)
    np.testing.assert_array_equal(nn(got.symbols), nn(ref.symbols))
    assert int(got.sync_word) == int(ref.sync_word)
    jax_fused = jplanar.demodulate_planar(xr, xi, p, fused=True)
    np.testing.assert_array_equal(nn(got.symbols),
                                  nn(jax_fused.symbols).astype(np.int32))


def test_fused_batched_decodes():
    p = LoraParams(sf=7)
    tp = tparams(p)
    payloads, xr, xi = _case(p, payload_len=8, batch=4)
    got = tplanar.demodulate_planar(tt(xr), tt(xi), tp, fused=True)
    np.testing.assert_array_equal(nn(tmodem.decode(got.symbols)), payloads)


def test_fused_windowed():
    p = LoraParams(sf=7, window=Window.HANN)
    tp = tparams(p)
    _, xr, xi = _case(p, payload_len=8)
    ref = tplanar.demodulate_planar(tt(xr), tt(xi), tp, fused=False)
    got = tplanar.demodulate_planar(tt(xr), tt(xi), tp, fused=True)
    np.testing.assert_array_equal(nn(got.symbols), nn(ref.symbols))


def test_fused_tie_break():
    """An alternating impulse train has bins 0 and N/2 exactly equal: the
    first maximum, bin 0, wins (the SF2 equal_power_bin_test generalised)."""
    p = LoraParams(sf=7)
    tp = tparams(p)
    x = torch.zeros(1, p.n)
    x[0, ::2] = 1.0
    bins = tfused.fused_detect_rows(x, torch.zeros(1, p.n), torch.zeros(1),
                                    torch.zeros(1), tp)
    assert bins.dtype == torch.int32 and int(bins[0]) == 0


@pytest.mark.parametrize("window", [Window.NONE, Window.HANN], ids=["none", "hann"])
@pytest.mark.parametrize("sf", [2, 3, 4, 5, 6, 7])
def test_twin_matches_jax_kernel_on_random_rows(sf, window):
    """2000 noise rows at random start (up to +-300 rad) and rate: the
    plain twin's bins equal the Pallas kernel's (interpret mode) bins."""
    p = LoraParams(sf=sf, window=window)
    tp = tparams(p)
    xr, xi, start, rate = _random_rows(p, 2000, seed=10 * sf + int(window))
    ref = nn(jfused.fused_detect_rows(xr, xi, start, rate, p))
    got = tfused.fused_detect_rows(tt(xr), tt(xi), tt(start), tt(rate), tp)
    np.testing.assert_array_equal(nn(got), ref)


def test_fused_demod_start_phase_vs_jax():
    """fused_demod's per-symbol start = rate*(s*N + t_off/osr) over a
    [..., S, N] batch with nonzero rate and t_off, at osr 2."""
    p = LoraParams(sf=6, osr=2)
    tp = tparams(p)
    rng = np.random.RandomState(3)
    yr = rng.randn(2, 3, 7, p.n).astype(np.float32)
    yi = rng.randn(2, 3, 7, p.n).astype(np.float32)
    rate = rng.uniform(-0.2, 0.2, (2, 3)).astype(np.float32)
    t_off = rng.randint(-40, 40, (2, 3)).astype(np.int32)
    ref = nn(jfused.fused_demod(yr, yi, rate, t_off, p))
    got = tfused.fused_demod(tt(yr), tt(yi), tt(rate), tt(t_off), tp)
    assert got.shape == (2, 3, 7)
    np.testing.assert_array_equal(nn(got), ref)


@pytest.mark.parametrize("window", [Window.NONE, Window.HANN], ids=["none", "hann"])
@pytest.mark.parametrize("sf", [5, 7])
def test_dft_tables_bit_equal(sf, window):
    p = LoraParams(sf=sf, window=window)
    w = jmodem._window_table(p)
    key = tuple(w) if w is not None else None
    for mine, ref in zip(tfused._dft_tables(p.n, key), jfused._dft_tables(p.n, key)):
        np.testing.assert_array_equal(mine, ref)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    # the CUDA kernel takes every N the wrapper takes (SF2-7, as JAX's)
    assert tfused.CUDA_N == tuple(1 << sf for sf in range(2, 8))
    p = LoraParams(sf=8)
    tp = tparams(p)
    x = torch.zeros(4, p.n)
    z = torch.zeros(4)
    with pytest.raises(ValueError, match="N <= 128"):
        tfused.fused_detect_rows(x, x, z, z, tp)
    with pytest.raises(ValueError, match="N <= 128"):
        jfused.fused_detect_rows(nn(x), nn(x), nn(z), nn(z), p)
    p = LoraParams(sf=7)
    tp = tparams(p)
    x = torch.zeros(4, p.n)
    with pytest.raises(TypeError, match="float32"):
        tfused.fused_detect_rows(x.double(), x, z, z, tp)
    with pytest.raises(ValueError, match="shape"):
        tfused.fused_detect_rows(x, x, torch.zeros(3), z, tp)
    with pytest.raises(ValueError, match="scale_rows must have shape"):
        tfused.fused_detect_rows(x, x, z, z, tp, torch.ones(3))


def _scaled_windows(p, seed):
    """[2, 3, 7, N] symbol windows of amplitude up to ~4, a per-frame
    scale in (0.2, 1], nonzero rate and t_off."""
    rng = np.random.RandomState(seed)
    yr = (3.0 * rng.randn(2, 3, 7, p.n)).astype(np.float32)
    yi = (3.0 * rng.randn(2, 3, 7, p.n)).astype(np.float32)
    scale = rng.uniform(0.2, 1.0, (2, 3)).astype(np.float32)
    rate = rng.uniform(-0.2, 0.2, (2, 3)).astype(np.float32)
    t_off = rng.randint(-40, 40, (2, 3)).astype(np.int32)
    return yr, yi, scale, rate, t_off


@pytest.mark.parametrize("window", [Window.NONE, Window.HANN], ids=["none", "hann"])
@pytest.mark.parametrize("sf", [5, 7])
def test_fused_demod_scale_vs_jax(sf, window):
    """fused_demod(..., scale=s) gives the bins of the JAX fused_demod on
    yr * s, yi * s (the multiply JAX's demodulate_planar makes first)."""
    p = LoraParams(sf=sf, window=window)
    tp = tparams(p)
    yr, yi, scale, rate, t_off = _scaled_windows(p, seed=sf + 10 * int(window))
    s4 = scale[..., None, None]
    ref = nn(jfused.fused_demod(yr * s4, yi * s4, rate, t_off, p))
    got = tfused.fused_demod(tt(yr), tt(yi), tt(rate), tt(t_off), tp, scale=tt(scale))
    np.testing.assert_array_equal(nn(got), ref)
    # the scale reaches the kernel's operands per row, broadcast per frame
    *rows, scale_rows = tfused.symbol_rows(tt(yr), tt(yi), tt(rate), tt(t_off), tp,
                                           tt(scale))
    np.testing.assert_array_equal(nn(scale_rows), np.repeat(scale.reshape(-1), 7))
    assert tfused.symbol_rows(tt(yr), tt(yi), tt(rate), tt(t_off), tp)[4] is None


@pytest.mark.parametrize("sf", [5, 7])
def test_demodulate_planar_fused_scaled_vs_jax(sf):
    """An input above unit amplitude (scale != 1): fused=True equals JAX's
    fused path and the port's plain path, symbols and sync."""
    p = LoraParams(sf=sf)
    tp = tparams(p)
    _, xr, xi = _case(p, payload_len=8, batch=3, seed=sf)
    gain = np.array([3.5, 1.0, 12.25], dtype=np.float32)[:, None]
    xr, xi = xr * gain, xi * gain
    got = tplanar.demodulate_planar(tt(xr), tt(xi), tp, fused=True)
    ref = jplanar.demodulate_planar(xr, xi, p, fused=True)
    np.testing.assert_array_equal(nn(got.symbols), nn(ref.symbols).astype(np.int32))
    np.testing.assert_array_equal(nn(got.sync_word), nn(ref.sync_word))
    plain = tplanar.demodulate_planar(tt(xr), tt(xi), tp, fused=False)
    np.testing.assert_array_equal(nn(got.symbols), nn(plain.symbols))


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64, 128])
def test_twiddle_table_quarter_points_exact(n):
    tw = tfused._twiddles(n)
    assert tw.dtype == np.float32 and tw.shape == (n, 2)
    q = n // 4
    np.testing.assert_array_equal(tw[[0, q, 2 * q, 3 * q]],
                                  [[1, 0], [0, -1], [-1, 0], [0, 1]])
    ang = 2 * np.pi * np.arange(n) / n
    np.testing.assert_allclose(tw[:, 0], np.cos(ang), atol=6e-8)
    np.testing.assert_allclose(tw[:, 1], -np.sin(ang), atol=6e-8)


def _bit_reverse(v, bits):
    return int(format(v, f"0{bits}b")[::-1], 2) if bits else 0


def _dif(re, im, w):
    """In-place radix-2 decimation-in-frequency FFT over the last axis (M
    points, natural input order, output position p holds bin
    bit_reverse(p)) in float32; ``w[e] = W_M^e``: the kernel's fft_dif."""
    m = re.shape[-1]
    half = m // 2
    while half >= 1:
        for blk in range(0, m, 2 * half):
            for i in range(half):
                a, b = blk + i, blk + i + half
                wr, wi = w[i * (m // (2 * half))]
                dr, di = re[..., a] - re[..., b], im[..., a] - im[..., b]
                re[..., a] += re[..., b]
                im[..., a] += im[..., b]
                re[..., b] = dr * wr - di * wi
                im[..., b] = dr * wi + di * wr
        half //= 2


def _kernel_emulation(xr, xi, start, rate, p):
    """The CUDA kernel's algorithm in numpy float32, stage for stage
    (csrc/fused_demod.cu steps 1-6): G = N/16 threads per row holding
    samples t + G*j, a 16-point FFT over j, the twiddles W_N^(t*k1), the
    transpose, G-point FFTs over t, first-max argmax on natural bins. At
    N <= 16 (fused_demod_small) one thread holds the row: one N-point FFT,
    then the argmax on natural bins."""
    n = p.n
    r, g = 16, n // 16
    tw = tfused._twiddles(n)
    col = np.arange(n, dtype=np.float32)
    ph = start[:, None] + rate[:, None] * col
    c, s = np.cos(ph), np.sin(ph)
    fr, fi = xr * c - xi * s, xr * s + xi * c
    w = jmodem._window_table(p)
    if w is not None:
        fr, fi = fr * w, fi * w
    if n <= 16:
        re, im = fr.copy(), fi.copy()
        _dif(re, im, tw)
        k = np.array([_bit_reverse(q, n.bit_length() - 1) for q in range(n)])
        mag = np.empty_like(re)
        mag[:, k] = re * re + im * im
        return np.argmax(mag, axis=-1).astype(np.int32)
    # [B, t, j]: thread t holds sample t + G*j
    re = fr.reshape(-1, r, g).transpose(0, 2, 1).copy()
    im = fi.reshape(-1, r, g).transpose(0, 2, 1).copy()
    _dif(re, im, tw[::g])
    k1 = np.array([_bit_reverse(q, 4) for q in range(r)])
    nat_re, nat_im = np.empty_like(re), np.empty_like(im)
    nat_re[..., k1], nat_im[..., k1] = re, im
    twk = tw[np.arange(g)[:, None] * np.arange(r)[None, :]]       # [t, k1, 2]
    ur = nat_re * twk[..., 0] - nat_im * twk[..., 1]
    ui = nat_re * twk[..., 1] + nat_im * twk[..., 0]
    # transpose to [B, k1, t], then the G-point FFTs over t
    ur, ui = ur.transpose(0, 2, 1).copy(), ui.transpose(0, 2, 1).copy()
    _dif(ur, ui, tw[::r])
    k2 = np.array([_bit_reverse(q, g.bit_length() - 1) for q in range(g)])
    mag = np.empty((xr.shape[0], n), dtype=np.float32)
    mag[:, np.arange(r)[:, None] + r * k2[None, :]] = ur * ur + ui * ui
    return np.argmax(mag, axis=-1).astype(np.int32)


@pytest.mark.parametrize("window", [Window.NONE, Window.HANN], ids=["none", "hann"])
@pytest.mark.parametrize("sf", [2, 3, 4, 5, 6, 7])
def test_kernel_fft_emulation_matches_twin(sf, window):
    """On 2000 noise rows the kernel's FFT (emulated in numpy) gives the
    dense twin's bins, except where the twin's top two magnitudes lie
    within 1e-5 relative; on dechirped chirp rows and the tie row, the
    same bins exactly."""
    p = LoraParams(sf=sf, window=window)
    tp = tparams(p)
    rows = _random_rows(p, 2000, seed=100 + 10 * sf + int(window))
    got = _kernel_emulation(*rows, p)
    ref = nn(tfused.fused_detect_rows_reference(*map(tt, rows), tp))
    differ = np.flatnonzero(got != ref)
    if differ.size:
        mag = tfused.reference_power(*(tt(a[differ]) for a in rows), tp)
        top2 = nn(mag.topk(2, dim=-1).values)
        assert ((top2[:, 0] - top2[:, 1]) <= 1e-5 * top2[:, 0]).all()
    _, xr, xi = _case(p, payload_len=8, batch=2, seed=sf)
    xr, xi = xr.reshape(-1, p.n), xi.reshape(-1, p.n)
    rng = np.random.RandomState(sf)
    start = rng.uniform(-300, 300, xr.shape[0]).astype(np.float32)
    rate = (rng.uniform(-0.3, 0.3, xr.shape[0]) * 2 * np.pi / p.n).astype(np.float32)
    np.testing.assert_array_equal(
        _kernel_emulation(xr, xi, start, rate, p),
        nn(tfused.fused_detect_rows_reference(tt(xr), tt(xi), tt(start), tt(rate), tp)))
    tie = np.zeros((1, p.n), np.float32)
    tie[0, ::2] = 1.0
    z = np.zeros(1, np.float32)
    assert int(_kernel_emulation(tie, np.zeros_like(tie), z, z, p)[0]) == 0


def test_ablation_variants_find_their_anchors():
    """Each variant of tools/torch_kernel_ablation.py finds every statement
    it replaces exactly once in the kernel's source, and changes it; at
    N <= 16 the tool runs only the variants that reach that kernel."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / "torch_kernel_ablation.py"
    spec = importlib.util.spec_from_file_location("torch_kernel_ablation", path)
    ablation = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ablation)
    shipped = ablation.variant_source([])
    for name, edits in ablation.VARIANTS.items():
        src = ablation.variant_source(edits)
        assert (src == shipped) == (not edits), name
        assert all(old not in src for old, _ in edits), name
    # the one-thread kernels (N <= 16) have no FFT anchors: only the
    # sincosf variant reaches them
    assert list(ablation.variants_for(8)) == ["kernel", "no_sincos"]
    assert list(ablation.variants_for(128)) == list(ablation.VARIANTS)


PTXAS_SAMPLE = """ptxas info    : 24 bytes gmem
ptxas info    : Compiling entry function '_ZN1a1kILi8ELb0EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN1a1kILi8ELb0EEEvPKf
    96 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 96 bytes cumulative stack size, 64 bytes smem
ptxas info    : Function properties for __internal_trig_reduction_slowpathd
    40 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN1a1kILi8ELb1EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN1a1kILi8ELb1EEEvPKf
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
"""
SASS_SAMPLE = """\tcode for sm_90a
\t\tFunction : _ZN1a1kILi8ELb0EEEvPKf
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
                                                               /* 0x000fe40000000800 */
        /*0010*/                   STL.128 [R1], R4 ;          /* 0x0000000401007387 */
        /*0020*/                   LDL.LU R3, [R1+0x10] ;      /* 0x0000100001037983 */
        /*0030*/                   CALL.REL.NOINC 0x1200 ;     /* 0x0000000000007944 */
\t\tFunction : _ZN1a1kILi8ELb1EEEvPKf
        /*0000*/                   EXIT ;                      /* 0x000000000000794d */
"""


def test_resource_tool_reads_ptxas_and_sass():
    """tools/torch_kernel_resources.py's parsers: each entry function's
    registers, shared memory, stack frame and spills from ptxas -v (device
    functions skipped), its instructions and local-memory and call
    instructions from cuobjdump -sass, and the short names it reports."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / "torch_kernel_resources.py"
    spec = importlib.util.spec_from_file_location("torch_kernel_resources", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    k0, k1 = "_ZN1a1kILi8ELb0EEEvPKf", "_ZN1a1kILi8ELb1EEEvPKf"
    assert tool.parse_ptxas(PTXAS_SAMPLE) == {
        k0: dict(stack=96, spill_stores=0, spill_loads=0, registers=40, smem=64),
        k1: dict(stack=0, spill_stores=8, spill_loads=4, registers=128, smem=0)}
    assert tool.parse_sass(SASS_SAMPLE) == {
        k0: dict(instructions=4, LDL=1, STL=1, CALL=1),
        k1: dict(instructions=1, LDL=0, STL=0, CALL=0)}
    assert tool.short("void <unnamed>::fused_demod_small<(int)8, (bool)0>(const float *, "
                      "long long)") == "fused_demod_small<8, 0>"
    assert tool.short("void (anonymous namespace)::bf16_decide_fourstep<(int)16, (int)32, "
                      "(bool)1>(const float *)") == "bf16_decide_fourstep<16, 32, 1>"
    assert tool.short("void fused_demod_small<4, false>") == "fused_demod_small<4, false>"


@pytest.mark.gpu
@pytest.mark.parametrize("window", [Window.NONE, Window.HANN], ids=["none", "hann"])
@pytest.mark.parametrize("sf", [2, 3, 4, 5, 6, 7])
def test_cuda_kernel_matches_twin(sf, window):
    """The CUDA kernel against its plain twin on the card: equal bins on
    clean chirp rows, scaled (amplitude above 1) or not; on noise rows, at
    row counts that do not fill a block (1, 7, 4097) and with a per-row
    scale, a differing bin only where the twin's top two magnitudes are
    within 1e-5 relative (a float32 near-tie); the tie row gives bin 0. At
    N = 8 (a block of 256 rows, one a thread) also 255, 256 and 257 rows,
    and 2048 x SMs + 1, more rows than the resident threads (at most 2048
    an SM) take in one pass."""
    dev = cuda_device()
    p = LoraParams(sf=sf, window=window)
    tp = tparams(p)
    _, xr, xi = _case(p, payload_len=24, batch=8)
    xr, xi = tt(xr).to(dev), tt(xi).to(dev)
    launches = tfused.LAUNCHES
    got = tplanar.demodulate_planar(xr, xi, tp, fused=True)
    assert tfused.LAUNCHES == launches + 1
    ref = tplanar.demodulate_planar(xr, xi, tp, fused=False)
    torch.testing.assert_close(got.symbols, ref.symbols, rtol=0, atol=0)

    gain = torch.tensor([[3.5]] * 4 + [[1.0]] * 4, device=dev)
    got = tplanar.demodulate_planar(xr * gain, xi * gain, tp, fused=True)
    ref = tplanar.demodulate_planar(xr * gain, xi * gain, tp, fused=False)
    torch.testing.assert_close(got.symbols, ref.symbols, rtol=0, atol=0)

    counts = [1, 7, 4097]
    if p.n == 8:
        counts += [255, 256, 257,
                   2048 * torch.cuda.get_device_properties(dev).multi_processor_count + 1]
    for b in counts:
        rows = [tt(a).to(dev) for a in _random_rows(p, b, seed=sf + b)]
        scale = torch.from_numpy(np.random.RandomState(b).uniform(0.2, 1.0, b)
                                 .astype(np.float32)).to(dev)
        for scale_rows in (None, scale):
            k = tfused.fused_detect_rows(*rows, tp, scale_rows)
            r = tfused.fused_detect_rows_reference(*rows, tp, scale_rows)
            torch.cuda.synchronize()
            assert k.shape == (b,)
            differ = (k != r).nonzero().flatten()
            if differ.numel():
                sr = None if scale_rows is None else scale_rows[differ]
                sub = [t[differ] for t in rows]
                if sr is not None:
                    sub[0], sub[1] = sub[0] * sr[:, None], sub[1] * sr[:, None]
                mag = tfused.reference_power(*sub, tp)
                top2 = mag.topk(2, dim=-1).values
                assert bool(((top2[:, 0] - top2[:, 1]) <= 1e-5 * top2[:, 0]).all())

    x = torch.zeros(1, p.n, device=dev)
    x[0, ::2] = 1.0
    z = torch.zeros(1, device=dev)
    assert int(tfused.fused_detect_rows(x, torch.zeros_like(x), z, z, tp)[0]) == 0
