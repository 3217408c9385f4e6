"""Port parity of ``runners/sic_sweep.py`` and ``runners/scope.py``
against the JAX twins on the CPU (``tests/test_sic.py:184`` and
``tests/test_runners.py:244``).

sic_sweep: the port's rows equal JAX's CSV rows when the port's sweep is
fed JAX's own noise draws (``PRNGKey(seed*100003 + trial)`` on the same
clean collision). scope: the receiver's rows equal JAX's (decisions
exactly, cfo within 1e-6 bins, snr_db within 1e-2 dB, sro_ppm within 0.05
ppm: the block receiver's tolerances), both panels within 1e-5 of the peak
of the numpy FFTs JAX's scope draws.
"""

import numpy as np
import pytest
import torch

from _torch_util import nn, run_cli, tparams
from lora_phy_tpu.models import modem as jmodem
from lora_phy_tpu.models import stream as jstream
from lora_phy_tpu.models import sync as jsync
from lora_phy_tpu.ops.chirp import base_downchirp_planar as jdown
from lora_phy_tpu.ops.impair import apply_awgn as japply_awgn
from lora_phy_tpu.runners import sic_sweep as jss
from lora_phy_tpu.utils.params import LoraParams
from lora_phy_tpu_torch.runners import scope as tscope
from lora_phy_tpu_torch.runners import sic_sweep as tss

CPU = ["--device=cpu"]
CFO_ATOL = 1e-6
SNR_ATOL_DB = 1e-2
SRO_ATOL_PPM = 0.05
PANEL_TOL = 1e-5          # of the panel's peak


# ---------------------------------------------------------------------------
# sic_sweep (test_sic.py:184)
# ---------------------------------------------------------------------------

def _jax_noise(seed, snr):
    import jax

    def noise(trial, clean):
        y = japply_awgn(jax.random.PRNGKey(seed * 100003 + trial), nn(clean), snr)
        return torch.from_numpy(np.array(y))
    return noise


def test_sic_sweep_runner_smoke(tmp_path, capfd):
    out = tmp_path / "sweep.csv"
    rc, _, err = run_cli(tss.main, ["--trials=2", "--gaps=9", f"--out={out}"] + CPU, capfd)
    assert rc == 0, err
    lines = out.read_text().strip().splitlines()
    assert lines[0] == ("gap_db,trials,weak_plain,weak_sic,strong_sic,"
                        "plain_lo,plain_hi,sic_lo,sic_hi")
    gap, trials, wp, ws, ss = lines[1].split(",")[:5]
    assert (gap, trials) == ("9", "2")
    assert int(ws) >= int(wp) and int(ss) == 2


def test_sic_sweep_rows_equal_jax_on_jax_draws(tmp_path, capfd):
    """The JAX runner's CSV and the port's sweep on JAX's noise draws:
    equal text, row for row (two gaps: the trial keys repeat per gap)."""
    out = tmp_path / "jax.csv"
    args = ["--trials=2", "--gaps=6,12", "--seed=3", "--snr=15"]
    assert run_cli(jss.main, args + [f"--out={out}"], capfd)[0] == 0
    rows = tss.sweep(tparams(LoraParams(sf=7)), [6.0, 12.0], 2, snr_db=15.0, seed=3,
                     device="cpu", noise=_jax_noise(3, 15.0))
    assert out.read_text().splitlines() == [tss.HEADER] + rows


def test_sic_sweep_clean_collision_equals_jax():
    """The clean collision the noise callable receives is JAX's, bit for bit."""
    p = LoraParams(sf=7)
    seen = []

    def noise(trial, clean):
        seen.append(nn(clean))
        return clean

    tss.sweep(tparams(p), [9.0], 1, device="cpu", noise=noise)
    rng = np.random.RandomState(0)
    pay_a = rng.randint(0, 256, 6).astype(np.uint8)
    pay_b = rng.randint(0, 256, 6).astype(np.uint8)
    off_a = 2 * p.step
    off_b = off_a + 5 * p.step
    fa = np.asarray(jstream.frame_modulate(np.asarray(jmodem.encode(pay_a), np.int32), p))
    fb = 10.0 ** (-9.0 / 20.0) * np.asarray(jstream.frame_modulate(
        np.asarray(jmodem.encode(pay_b), np.int32), p))
    s = np.zeros(off_b + fb.size + 4 * p.step, np.complex64)
    s[off_a: off_a + fa.size] += fa.astype(np.complex64)
    s[off_b: off_b + fb.size] += fb.astype(np.complex64)
    np.testing.assert_array_equal(seen[0], s)


# ---------------------------------------------------------------------------
# scope (test_runners.py:244)
# ---------------------------------------------------------------------------

def _capture(p, lead=3, payload=np.arange(8, dtype=np.uint8)):
    fr = np.asarray(jstream.frame_modulate(np.asarray(jmodem.encode(payload), np.int32), p))
    sig = np.zeros(lead * p.step + fr.size + 4 * p.step, np.complex64)
    sig[lead * p.step: lead * p.step + fr.size] = fr
    return sig


def _write_cf32(path, sig):
    inter = np.empty(sig.size * 2, np.float32)
    inter[0::2], inter[1::2] = sig.real, sig.imag
    path.write_bytes(inter.tobytes())


def test_scope_runner(tmp_path, capfd):
    """lora-scope writes a two-panel waterfall PNG and annotates the
    frames the block receiver finds."""
    pytest.importorskip("matplotlib")
    iqf = tmp_path / "cap.iq"
    _write_cf32(iqf, _capture(LoraParams(sf=7)))
    out = tmp_path / "scope.png"
    rc, _, err = run_cli(tscope.main, [f"--in={iqf}", "--sf=7", "--payload-len=8",
                                       f"--out={out}"] + CPU, capfd)
    assert rc == 0 and out.exists() and out.stat().st_size > 10000
    assert "(1 frames annotated)" in err
    assert run_cli(tscope.main, ["--sf=7"] + CPU, capfd)[0] == 1      # missing --in
    assert run_cli(tscope.main, [f"--in={iqf}", "--format=cu8"] + CPU, capfd)[0] == 1


def test_scope_without_matplotlib(tmp_path, capfd, monkeypatch):
    """No matplotlib: one line naming it, exit 1, no PNG."""
    import builtins

    real_import = builtins.__import__

    def no_mpl(name, *args, **kw):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ModuleNotFoundError(f"No module named {name!r}", name="matplotlib")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    iqf = tmp_path / "cap.iq"
    _write_cf32(iqf, _capture(LoraParams(sf=7)))
    out = tmp_path / "scope.png"
    rc, _, err = run_cli(tscope.main, [f"--in={iqf}", "--payload-len=8",
                                       f"--out={out}"] + CPU, capfd)
    assert rc == 1 and not out.exists()
    assert len(err.strip().splitlines()) == 1 and "matplotlib" in err


def _jax_panels(sig, p, payload_len, robust):
    """JAX's scope computation (lora_phy_tpu/runners/scope.py:66-90)."""
    step, n = p.step, p.n
    nwin = sig.size // step
    w = sig[: nwin * step].reshape(nwin, step)
    stft = np.fft.fftshift(np.abs(np.fft.fft(w, axis=-1)), axes=-1)
    dr, di = jdown(p.sf, p.scale, p.osr)
    dech = (w * (dr + 1j * di)).reshape(nwin, n, p.osr)[:, :, 0]
    upspec = np.abs(np.fft.fft(dech, axis=-1))
    x = w.reshape(-1)
    blk = jsync.receive_block_planar(
        x.real.astype(np.float32), x.imag.astype(np.float32), p, payload_len * 2,
        max_frames=16, min_power_db=-30.0, pre_acc=3 if robust else 1)
    return stft, upspec, jsync.block_rows(blk)


@pytest.mark.parametrize("sf,osr,robust,frames", [(7, 1, False, 3), (8, 2, True, 2)])
def test_scope_panels_and_rows_vs_jax(sf, osr, robust, frames):
    p = LoraParams(sf=sf, osr=osr)
    rng = np.random.RandomState(sf)
    parts = []
    pays = []
    for _ in range(frames):
        pay = rng.randint(0, 256, 8).astype(np.uint8)
        pays.append(pay)
        parts.append(_capture(p, lead=2, payload=pay))
    sig = np.concatenate(parts + [np.zeros(p.step // 3, np.complex64)])
    sig = (sig + 0.05 * (rng.randn(sig.size) + 1j * rng.randn(sig.size))).astype(np.complex64)
    st, up, rows = tscope.panels(torch.from_numpy(sig.real.copy()),
                                 torch.from_numpy(sig.imag.copy()), tparams(p), 8,
                                 robust=robust)
    jst, jup, jrows = _jax_panels(sig, p, 8, robust)
    for got, ref in ((st, jst), (up, jup)):
        assert tuple(got.shape) == ref.shape
        assert np.abs(nn(got) - ref).max() <= PANEL_TOL * ref.max()
    assert len(rows) == len(jrows) == frames
    for r, j, pay in zip(rows, jrows, pays):
        assert (r["k"], r["start"], r["cfo_bins"], r["sync"]) == \
            (j["k"], j["start"], j["cfo_bins"], j["sync"])
        np.testing.assert_array_equal(nn(r["symbols"]), np.asarray(j["symbols"]))
        np.testing.assert_array_equal(np.asarray(jmodem.decode(np.asarray(j["symbols"]))), pay)
        assert abs(r["cfo"] - j["cfo"]) <= CFO_ATOL
        assert abs(r["snr_db"] - j["snr_db"]) <= SNR_ATOL_DB
        assert abs(r["sro_ppm"] - j["sro_ppm"]) <= SRO_ATOL_PPM


def test_scope_panels_reject_short_input():
    with pytest.raises(ValueError, match="two symbol windows"):
        tscope.panels(torch.zeros(200), torch.zeros(200), tparams(LoraParams(sf=7)))
