"""Port parity of the gateway command line: lora_phy_tpu_torch.runners
``tx_stream --coded`` / ``rx_stream --adaptive [--soft] [--ldro]`` on the
adaptive cases of ``tests/test_rx_stream.py``, beside the JAX runners on
the same files and flags, compared as in ``test_torch_rx_stream.py``
(decision fields exactly, ``margin=`` within one printed digit plus 1e-4
relative); TX files byte-equal and usage errors equal."""

import numpy as np

from _torch_util import run_cli
from lora_phy_tpu.runners import tx_stream as jtx
from lora_phy_tpu.utils.params import LoraParams
from lora_phy_tpu_torch.runners import tx_stream as ttx
from test_rx_stream import _interleave
from test_torch_rx_stream import CPU, both_rx, both_tx



def test_adaptive_gateway_mode(tmp_path, capfd):
    plist = tmp_path / "plist.txt"
    pays = ["deadbeef", "cafebabe001122334455667788", "0102"]
    plist.write_text("".join(h + "\n" for h in pays))
    sfile = both_tx([f"--payloads={plist}", "--coded", "--cr=2", "--crc",
                     "--gap=1200"], tmp_path, capfd, "coded.iq")
    args = [f"--in={sfile}", "--sf=7", "--adaptive", "--block=4096"]
    rc, out, err = both_rx(args, capfd)
    lines = [l for l in out.splitlines() if l.startswith("frame @")]
    assert rc == 0 and len(lines) == 3 and "3 frames" in err
    for line, hx in zip(lines, pays):
        assert f"len={len(hx) // 2}" in line and "cr=4/6 crc=ok" in line
        assert f"payload={hx}" in line
    rc, soft_out, _ = both_rx(args + ["--soft"], capfd)
    soft_lines = [l for l in soft_out.splitlines() if l.startswith("frame @")]
    assert rc == 0 and len(soft_lines) == 3 and all("margin=" in l for l in soft_lines)


def test_tx_coded_validation(tmp_path, capfd):
    big = "ab" * 256
    assert both_tx([f"--payload={big}", "--coded"], tmp_path, capfd) is None
    assert both_tx(["--payload=0102", "--coded", "--cr=5"], tmp_path, capfd) is None
    for args in ([f"--payload={big}", "--coded"], ["--payload=0102", "--coded", "--cr=5"],
                 ["--payload=01", "--format=cs8"], []):
        j = run_cli(jtx.main, args + [f"--out={tmp_path / 'j.iq'}"], capfd)
        t = run_cli(ttx.main, args + [f"--out={tmp_path / 't.iq'}"] + CPU, capfd)
        assert t[0] == j[0] == 1 and t[2] == j[2], args


def test_adaptive_gateway_under_cfo_and_noise(tmp_path, capfd):
    import jax

    from lora_phy_tpu.ops.impair import apply_awgn, apply_cfo_continuous

    plist = tmp_path / "p.txt"
    pays = ["deadbeefcafe", "001122334455667788"]
    plist.write_text("".join(h + "\n" for h in pays))
    clean = both_tx([f"--payloads={plist}", "--coded", "--crc", "--gap=1100"],
                    tmp_path, capfd, "clean.iq")
    raw = np.frombuffer(clean.read_bytes(), np.float32)
    sig = (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
    p = LoraParams(sf=7)
    y = apply_cfo_continuous(sig, 1.7, p.n, p.osr)
    y = np.asarray(apply_awgn(jax.random.PRNGKey(77), y, 15.0))
    path = tmp_path / "noisy.iq"
    path.write_bytes(_interleave(y))
    rc, out, err = both_rx([f"--in={path}", "--sf=7", "--adaptive"], capfd)
    lines = [l for l in out.splitlines() if l.startswith("frame @")]
    assert rc == 0 and len(lines) == 2 and "2 frames" in err
    for line, hx in zip(lines, pays):
        assert "crc=ok" in line and f"payload={hx}" in line and "cfo_bins=2" in line


def test_adaptive_gateway_ldro(tmp_path, capfd):
    pay = "0badc0de51"
    sfile = both_tx([f"--payload={pay}", "--coded", "--crc", "--ldro", "--cr=2"],
                    tmp_path, capfd, "ldro.iq")
    rc, out, err = both_rx([f"--in={sfile}", "--sf=7", "--adaptive", "--ldro"], capfd)
    lines = [l for l in out.splitlines() if l.startswith("frame @")]
    assert rc == 0 and len(lines) == 1 and "1 frames" in err
    assert f"payload={pay}" in lines[0] and "crc=ok" in lines[0]
    _, out, _ = both_rx([f"--in={sfile}", "--sf=7", "--adaptive"], capfd)
    assert f"payload={pay}" not in out
