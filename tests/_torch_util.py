"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

Each test feeds the same numpy-seeded inputs to a JAX function and its
twin in ``lora_phy_tpu_torch`` and compares the outputs as numpy arrays.
Torch is held to two threads so that several test workers do not
oversubscribe the cores.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from lora_phy_tpu.utils.params import Bandwidth, LoraParams, Window
from lora_phy_tpu_torch.utils.params import from_fields

torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
GOLDEN = sorted((FIXTURES / "golden").glob("*.npz"))


def tt(a) -> torch.Tensor:
    """numpy / JAX array -> CPU tensor (a private copy)."""
    return torch.from_numpy(np.array(a))


def nn(x) -> np.ndarray:
    """tensor / JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tparams(p):
    """The port's own ``LoraParams`` with the fields of the JAX params
    ``p``: every port call in the tests takes these."""
    return from_fields(p)


def golden_params(name: str) -> LoraParams:
    """LoraParams of a golden fixture from its file stem, e.g.
    ``sf7_bw125000_osr1_win0`` (as tests/test_modem_golden.py parses it)."""
    toks = name.split("_")
    sf = int(toks[0][2:])
    bw = Bandwidth(int(toks[1][2:]))
    osr = int(toks[2][3:])
    win = Window.HANN if toks[3][3:] == "1" else Window.NONE
    return LoraParams(sf=sf, bw=bw, osr=osr, window=win)


def cuda_device() -> torch.device:
    """The first CUDA device; skips the calling test where there is none
    (decided at run time, never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU: see README, "
                    "'PyTorch/CUDA port')")
    return torch.device("cuda", 0)


# ---------------------------------------------------------------------------
# The command line: runs of a runner's main() and its output lines compared
# across the two packages
# ---------------------------------------------------------------------------

# printed floats: snr_db agrees within 1e-2 dB and sro_ppm within 0.05 ppm,
# so a value printed to one decimal differs by at most one printed digit;
# JSON rounds to two decimals (half-way cases add a digit); soft margins
# agree within 1e-4 relative (ROADMAP, Queue 3)
PRINTED_1DP = 0.1 + 1e-9
JSON_SNR_TOL = 0.01 + 0.01 + 1e-9
JSON_SRO_TOL = 0.05 + 0.01 + 1e-9
MARGIN_RTOL = 1e-4


def run_cli(main, args, capfd):
    """``main(args)`` with stdout/stderr captured: (rc, out, err). A
    ``SystemExit`` (flag errors) gives its code."""
    try:
        rc = main(list(args))
    except SystemExit as e:
        rc = e.code
    out, err = capfd.readouterr()
    return rc, out, err


def _float_field(tok: str, key: str, unit: str) -> float:
    return float(tok[len(key) + 1: len(tok) - len(unit)])


def same_frame_line(a: str, b: str) -> bool:
    """Two output lines of a receiver: equal but for the printed
    ``snr=``/``sro=`` (one printed digit) and ``margin=`` (one printed
    digit plus MARGIN_RTOL); JSON lines field by field with the JSON
    tolerances."""
    if a.startswith("{"):
        ra, rb = json.loads(a), json.loads(b)
        if set(ra) != set(rb):
            return False
        for k in ra:
            if k == "snr_db":
                ok = abs(ra[k] - rb[k]) <= JSON_SNR_TOL
            elif k == "sro_ppm":
                ok = abs(ra[k] - rb[k]) <= JSON_SRO_TOL
            elif k == "soft_margin":
                ok = abs(ra[k] - rb[k]) <= 0.01 + MARGIN_RTOL * abs(rb[k]) + 1e-9
            else:
                ok = ra[k] == rb[k]
            if not ok:
                return False
        return True
    ta, tb = a.split(), b.split()
    if len(ta) != len(tb):
        return False
    for x, y in zip(ta, tb):
        key = x.split("=", 1)[0]
        if key != y.split("=", 1)[0]:
            return False
        if key == "snr" and x.endswith("dB"):
            ok = abs(_float_field(x, key, "dB") - _float_field(y, key, "dB")) <= PRINTED_1DP
        elif key == "sro" and x.endswith("ppm"):
            ok = abs(_float_field(x, key, "ppm") - _float_field(y, key, "ppm")) <= PRINTED_1DP
        elif key == "margin":
            mx, my = _float_field(x, key, ""), _float_field(y, key, "")
            ok = abs(mx - my) <= PRINTED_1DP + MARGIN_RTOL * abs(my)
        else:
            ok = x == y
        if not ok:
            return False
    return True


def assert_same_lines(port_out: str, jax_out: str) -> list[str]:
    """The receivers' non-empty stdout lines agree one for one
    (:func:`same_frame_line`); returns the port's lines."""
    pa = [l for l in port_out.splitlines() if l.strip()]
    ja = [l for l in jax_out.splitlines() if l.strip()]
    assert len(pa) == len(ja), (pa, ja)
    for x, y in zip(pa, ja):
        assert same_frame_line(x, y), (x, y)
    return pa
