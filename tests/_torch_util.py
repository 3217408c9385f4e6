"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

Each test feeds the same numpy-seeded inputs to a JAX function and its
twin in ``lora_phy_tpu_torch`` and compares the outputs as numpy arrays.
Torch is held to two threads so that several test workers do not
oversubscribe the cores.
"""

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
