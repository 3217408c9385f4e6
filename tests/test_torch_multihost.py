"""Port parity of the multi-process mesh (``tests/test_multihost.py:27``):
two local processes join one gloo process group, each owns four CPU time
shards of one global (channel, time) mesh, and the port's sharded
receivers run with the halo crossing the process seam over the group and
the amplitude pmax and estimate broadcast as all_reduce — checked in
each worker against the port's single-device functions
(``tests/_torch_mh_worker.py``), and here against the JAX package's
single-device demod on the same data.

A worker that does not finish within its timeout fails the test."""

import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER_TIMEOUT_S = 240


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_stream_parity():
    repo = pathlib.Path(__file__).resolve().parents[1]
    worker = repo / "tests" / "_torch_mh_worker.py"
    coord = f"localhost:{_free_port()}"
    nproc = 2
    procs = [
        subprocess.Popen([sys.executable, str(worker), str(i), str(nproc), coord],
                         cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for i in range(nproc)
    ]
    outs = []
    for i, proc in enumerate(procs):
        try:
            out, err = proc.communicate(timeout=WORKER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail(f"worker {i} timed out after {WORKER_TIMEOUT_S} s")
        outs.append((proc.returncode, out, err))
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {i} failed:\n{err[-3000:]}"
        for tag in ("COLLECTIVES OK", "PARITY OK", "SCAN OK"):
            assert f"{tag} process {i}/{nproc}" in out, out


def test_worker_data_decodes_in_jax():
    """The workers' stream (seed 7, a 2.5x louder second half) through the
    JAX package's single-device demod gives the payloads the workers
    check their gathered symbols against."""
    import torch

    from _torch_util import nn
    from lora_phy_tpu.models import modem as jmodem
    from lora_phy_tpu.ops import planar as jplanar
    from lora_phy_tpu.utils.params import LoraParams
    from lora_phy_tpu_torch.models import modem as tmodem
    from lora_phy_tpu_torch.ops import planar as tplanar
    from lora_phy_tpu_torch.parallel import mesh as tmeshlib
    from lora_phy_tpu_torch.parallel.stream import demodulate_stream_planar

    p = LoraParams(sf=7)
    payloads = np.random.RandomState(7).randint(0, 256, (2, 31)).astype(np.uint8)
    jr, ji = jplanar.dechirp_planar(*jplanar.modulate_planar(jmodem.encode(payloads), p), p)
    jr, ji = np.array(jr), np.array(ji)
    half = jr.shape[-1] // 2
    jr[:, half:] *= 2.5
    ji[:, half:] *= 2.5
    ref = jplanar.demodulate_planar(jr, ji, p)
    np.testing.assert_array_equal(nn(jmodem.decode(ref.symbols)), payloads)
    tp = tmodem.LoraParams(sf=7)
    tr, ti = tplanar.dechirp_planar(
        *tplanar.modulate_planar(tmodem.encode(torch.from_numpy(payloads)), tp), tp)
    # the workers build the stream with the port's TX: equal to JAX's
    # within the main path's dechirp tolerance (XLA's FMA)
    np.testing.assert_allclose(nn(tr[:, :half]), jr[:, :half], rtol=0, atol=1.3e-7)
    mesh = tmeshlib.make_mesh(1, 8, devices=[torch.device("cpu")] * 8)
    syms, sync, _, _ = demodulate_stream_planar(torch.from_numpy(jr), torch.from_numpy(ji),
                                                tp, mesh)
    np.testing.assert_array_equal(nn(syms[:, 2:]), nn(ref.symbols))
    np.testing.assert_array_equal(nn(sync), nn(ref.sync_word))
