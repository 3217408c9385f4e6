"""Port parity of the flowgraph runtime: lora_phy_tpu_torch.models.
flowgraph and runners/topology_runner against the JAX package's, case
for case with ``tests/test_flowgraph.py`` (``:49``, ``:61``, ``:73``,
``:145``) and on Pothos ``.pth`` files the tests write (the reference's
example files are absent): ``chip_smoke.topology_doc``, a simulation
chain with a breaker net, a disabled block and connection, signal wires
into an evaluator, a plotter tap and an implicit decoder with
``dataLength``.

Both packages run the same graph on the same numpy-seeded noise (the
noise source's ``RandomState``). Compared exactly: every decoded message,
the ``dropped`` counts, the integer-CFO ``error`` signal, the graph's
size and the runner's lines but the printed SNR; the ``snr`` signal
within 1e-2 dB (one printed digit in the runner's lines). The port runs
on the CPU (``device="cpu"``).
"""

import json
import math

import numpy as np
import pytest
import torch

from _torch_util import nn, run_cli, tparams
from chip_smoke import topology_doc
from lora_phy_tpu.models import flowgraph as jfg
from lora_phy_tpu.models.coded import CodedConfig as JCfg
from lora_phy_tpu.runners import topology_runner as jrunner
from lora_phy_tpu.utils.params import LoraParams
from lora_phy_tpu_torch.models import flowgraph as tfg
from lora_phy_tpu_torch.models.coded import CodedConfig as TCfg
from lora_phy_tpu_torch.runners import topology_runner as trunner

SNR_TOL = 1e-2


def _sim_topology(fg, cfg_cls, noise_ampl: float, seed: int, sf: int = 7, **kw):
    """test_flowgraph._sim_topology in either package: test_gen -> encoder
    -> mod -> +noise -> demod -> decoder -> probe."""
    t = fg.Topology(**kw)
    cfg = cfg_cls(sf=sf, cr=4)
    p = LoraParams(sf=sf) if fg is jfg else tparams(LoraParams(sf=sf))
    t.add(fg.make_test_gen("gen"))
    t.add(fg.make_pacer("pacer"))
    t.add(fg.make_encoder("enc", cfg))
    t.add(fg.make_modulator("mod", p, padding=2))
    noise = t.add(fg.make_noise_source("noise", ampl=noise_ampl, seed=seed))
    t.add(fg.make_arithmetic("add"))
    t.add(fg.make_demodulator("demod", p))
    t.add(fg.make_decoder("dec", cfg))
    t.add(fg.make_probe("chat"))
    t.add(fg.make_probe("snr_disp"))
    for w in (("gen", "0", "pacer", "0"), ("pacer", "0", "enc", "0"),
              ("enc", "0", "mod", "0"), ("mod", "0", "add", "1"),
              ("noise", "0", "add", "0"), ("add", "0", "demod", "0"),
              ("demod", "0", "dec", "0"), ("dec", "0", "chat", "in")):
        t.connect(*w)
    t.connect_signal("demod", "snr", "snr_disp", "setFloatValue")
    noise.state["length"] = 20000
    return t


def _msg(v):
    if v is None:
        return None
    return nn(v).astype(np.uint8).tobytes()


def assert_same_logs(tlog, jlog):
    """The two runs' logs: the same blocks, the same ports per tick, equal
    messages / counts / errors, snr within SNR_TOL, symbol bins equal."""
    assert sorted(tlog) == sorted(jlog)
    for name in jlog:
        assert len(tlog[name]) == len(jlog[name])
        for to, jo in zip(tlog[name], jlog[name]):
            assert sorted(to) == sorted(jo), (name, sorted(to), sorted(jo))
            for port, jv in jo.items():
                tv = to[port]
                if port == "snr":
                    assert abs(tv - jv) <= SNR_TOL, (name, tv, jv)
                elif port in ("dropped", "error", "ampl", "triggered", "valueChanged"):
                    assert tv == jv, (name, port, tv, jv)
                elif name in ("dec", "gen", "pacer") or name.startswith(("Decoder", "TestGen")):
                    assert _msg(tv) == _msg(jv), (name, port)
                elif port == "0" and name.startswith(("demod", "Demod")):
                    np.testing.assert_array_equal(nn(tv), nn(jv).astype(np.int64))


@pytest.mark.parametrize("noise_ampl, seed, ticks", [(0.05, 1, 3), (3.0, 7, 8)])
def test_programmatic_roundtrip_with_noise(noise_ampl, seed, ticks):
    """test_flowgraph.py:49, and a noise level where frames drop: the same
    messages, drop counts and SNR signals as the JAX graph."""
    j = _sim_topology(jfg, JCfg, noise_ampl, seed)
    t = _sim_topology(tfg, TCfg, noise_ampl, seed, device="cpu")
    jlog, tlog = j.run(ticks), t.run(ticks)
    assert_same_logs(tlog, jlog)
    msgs = [_msg(o["0"]) for o in tlog["dec"] if o.get("0") is not None]
    if noise_ampl < 1:
        assert msgs == [b"lora test message %d" % i for i in range(ticks)]
        assert tlog["dec"][-1]["dropped"] == 0
        snrs = [c["slots"]["setFloatValue"] for c in t.blocks["snr_disp"].captured
                if "slots" in c]
        assert snrs and all(s > 10.0 for s in snrs)
    else:
        # the knee: some frames decode, some are dropped or never sync
        assert 0 < len(msgs) < ticks
        assert max(o.get("dropped", 0) for o in tlog["dec"]) > 0
    for cap_t, cap_j in zip(t.blocks["chat"].captured, j.blocks["chat"].captured):
        assert cap_t["in"] == cap_j["in"].tobytes()


def test_heavy_noise_drops_frames():
    """test_flowgraph.py:61: far below the waterfall knee frames do not
    sync or are counted as dropped, in both packages alike."""
    j = _sim_topology(jfg, JCfg, 30.0, 3)
    t = _sim_topology(tfg, TCfg, 30.0, 3, device="cpu")
    jlog, tlog = j.run(3), t.run(3)
    assert_same_logs(tlog, jlog)
    got = [o for o in tlog["dec"] if o.get("0") is not None]
    dropped = max((o.get("dropped", 0) for o in tlog["dec"]), default=0)
    missed = all(o.get("0") is None for o in tlog["demod"])
    assert missed or dropped > 0 or len(got) < 3


def test_topology_cycle_detection():
    """test_flowgraph.py:73."""
    t = tfg.Topology(device="cpu")
    t.add(tfg.make_pacer("a"))
    t.add(tfg.make_pacer("b"))
    t.connect("a", "0", "b", "0")
    t.connect("b", "0", "a", "0")
    with pytest.raises(ValueError, match="cycle"):
        t.run(1)
    with pytest.raises(ValueError, match="duplicate"):
        t.add(tfg.make_pacer("a"))


def test_topology_device():
    """Blocks run on the topology's device; without a card and without
    ``device=`` the topology refuses (no CPU fallback)."""
    t = tfg.Topology(device="cpu")
    gen = t.add(tfg.make_test_gen("g"))
    assert gen.device == torch.device("cpu")
    out = gen.fn(gen, {})["0"]
    assert out.device.type == "cpu" and out.dtype == torch.uint8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfg.Topology()


def test_signal_blocks_and_elementwise_blocks():
    """The evaluator / constant / noise signal network and the elementwise
    blocks against the JAX package's on the same inputs: rotate bit-equal
    (complex128 rounding, as numpy), the adder, subtracter and the noise
    burst bit-equal; the complex product within 1e-6 relative, dc_removal
    and freq_demod within 1e-6."""
    rng = np.random.RandomState(5)
    x = (rng.randn(300) + 1j * rng.randn(300)).astype(np.complex64)
    y = (rng.randn(200) + 1j * rng.randn(200)).astype(np.complex64)
    tdev = torch.device("cpu")

    def both(make, *args, inputs):
        jb, tb = getattr(jfg, make)("b", *args), getattr(tfg, make)("b", *args)
        tb.device = tdev
        jo = jb.fn(jb, dict(inputs))
        to = tb.fn(tb, {k: torch.from_numpy(v) for k, v in inputs.items()})
        return nn(to["0"]), np.asarray(jo["0"])

    a, b = both("make_rotate", 0.7, inputs={"0": x})
    np.testing.assert_array_equal(a, b)
    for op in ("ADD", "SUB"):
        a, b = both("make_arithmetic", op, inputs={"0": x, "1": y})
        np.testing.assert_array_equal(a, b)
    # a complex product rounds differently in torch and numpy (one ulp)
    a, b = both("make_arithmetic", "MUL", inputs={"0": x, "1": y})
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    a, b = both("make_dc_removal", inputs={"0": x})
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    a, b = both("make_freq_demod", inputs={"0": x})
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)

    jn, tn = jfg.make_noise_source("n", ampl=0.3, seed=9), tfg.make_noise_source("n", ampl=0.3, seed=9)
    tn.device = tdev
    for blk in (jn, tn):
        blk.state["length"] = 1000
        blk.set_slot("setAmplitude", 0.125)
    for _ in range(2):
        jo, to = jn.fn(jn, {}), tn.fn(tn, {})
        np.testing.assert_array_equal(nn(to["0"]), jo["0"])
        assert to["ampl"] == jo["ampl"] == 0.125

    je, te = (fg.make_evaluator("e", "pow(10, db / 20.0)", ("db",)) for fg in (jfg, tfg))
    assert te.fn(te, {}) == je.fn(je, {}) == {}
    for blk in (je, te):
        blk.set_slot("setDb", -30.0)
    assert te.fn(te, {}) == je.fn(je, {}) == {"triggered": 10 ** (-30 / 20.0)}
    tc = tfg.make_constant("c", 4.5)
    assert tc.fn(tc, {}) == {"valueChanged": 4.5} and tc.fn(tc, {}) == {}


def test_iq_file_source_and_sink(tmp_path):
    """The IQ file blocks through the port's iqio: chunks on the device,
    appended to the sink's file; the JAX blocks read the same chunks."""
    from lora_phy_tpu_torch.utils import iqio

    rng = np.random.RandomState(2)
    x = (rng.randn(1000) + 1j * rng.randn(1000)).astype(np.complex64)
    src_path, out_path = tmp_path / "in.iq", tmp_path / "out.iq"
    iqio.write_iq(src_path, x)
    t = tfg.Topology(device="cpu")
    t.add(tfg.make_iq_file_source("src", str(src_path), chunk=400))
    t.add(tfg.make_iq_file_sink("sink", str(out_path)))
    t.connect("src", "0", "sink", "0")
    log = t.run(4)
    assert [tuple(o["0"].shape) if o else () for o in log["src"]] == [(400,), (400,), (200,), ()]
    np.testing.assert_array_equal(iqio.read_iq(out_path), x)
    jsrc = jfg.make_iq_file_source("src", str(src_path), chunk=400)
    np.testing.assert_array_equal(jsrc.fn(jsrc, {})["0"], nn(log["src"][0]["0"]))


def test_safe_eval_rejects_sandbox_escape():
    """test_flowgraph.py:145: the AST whitelist, with the JAX package's
    values on the accepted expressions."""
    for expr, env in (("1 << (SF - 2)", {"SF": 7}), ("0x12", None),
                      ("pow(2, SF)", {"SF": 8}), ("math.sqrt(2) * pi", None),
                      ("{'a': 1, 'b': SF}", {"SF": 9}), ("2 * math.pi", None),
                      ("math.e", None), ("SF == 0 or 10 / SF > 1", {"SF": 0}),
                      ("SF != 0 and 10 / SF > 1", {"SF": 0}),
                      ("3 if SF > 7 else -1", {"SF": 9}), ("[1, (2, 3)]", None),
                      ("not 1 < SF <= 12", {"SF": 7}), ("~5 ^ 3 | 8 & 12", None)):
        assert tfg.safe_eval(expr, env) == jfg.safe_eval(expr, env), expr
    assert tfg.safe_eval("1 << (SF - 2)", {"SF": 7}) == 32
    assert tfg.safe_eval("math.sqrt(2) * pi") == math.sqrt(2) * math.pi
    for evil in (
        "().__class__.__base__.__subclasses__()",
        "(1).__class__",
        "[c for c in ()]",
        "(lambda: 1)()",
        "open('/etc/passwd')",
        "__import__('os')",
        "math.pi(2)",
        "math.__dict__",
        "int(x=1)",
        "{**{}}",
        "unknown_name",
    ):
        with pytest.raises(ValueError):
            tfg.safe_eval(evil)


@pytest.fixture
def sim_pth(tmp_path):
    path = tmp_path / "sim.pth"
    path.write_text(json.dumps(topology_doc()))
    return path


def test_load_topology_pth(sim_pth):
    """load_topology on the written file: the same blocks, wires, signal
    wires and noise-burst length as JAX's loader; the disabled block and
    connection are skipped, the breaker net becomes a wire, the implicit
    decoder carries dataLength; three ticks give JAX's log."""
    j = jfg.load_topology(str(sim_pth), overrides={"SF": 7})
    t = tfg.load_topology(str(sim_pth), overrides={"SF": 7}, device="cpu")
    assert sorted(t.blocks) == sorted(j.blocks)
    assert "TestGenOff" not in t.blocks
    assert sorted(t.wires) == sorted(j.wires)
    assert ("Mod0", "0", "Adder0", "1") in t.wires
    assert ("Adder0", "0", "WaveMonitor1", "1") not in t.wires
    assert sorted(t.signal_wires) == sorted(j.signal_wires)
    assert t.blocks["DecoderImpl"].state["length"] == 19
    assert t.blocks["NoiseSource1"].state["length"] == j.blocks["NoiseSource1"].state["length"]
    jlog, tlog = j.run(3), t.run(3)
    assert_same_logs(tlog, jlog)
    chat = [c["in"] for c in t.blocks["ChatBox1"].captured if "in" in c]
    assert chat == [b"lora test message %d" % i for i in range(3)]
    assert [c["in"] for c in t.blocks["ChatImpl"].captured] == chat
    # the numeric entry -> evaluator -> noise amplitude network engaged
    ampl = [o["ampl"] for o in tlog["NoiseSource1"] if "ampl" in o]
    assert ampl[-1] == pytest.approx(10 ** (-30 / 20.0), rel=1e-6)
    assert t.blocks["WaveMonitor1"].captured


@pytest.mark.parametrize("args", [["--ticks=3", "--sf=7"],
                                  ["--ticks=2", "--sf=8", "--mtu=24", "--seed=4",
                                   "--sync=0x34"]])
def test_topology_runner_lines_equal_jax(sim_pth, capfd, args):
    """topology_runner's lines equal the JAX runner's (snr= within one
    printed digit)."""
    jrc, jout, _ = run_cli(jrunner.main, [f"--file={sim_pth}"] + args, capfd)
    trc, tout, _ = run_cli(trunner.main, [f"--file={sim_pth}"] + args + ["--device=cpu"],
                           capfd)
    assert trc == jrc == 0
    jl, tl = jout.splitlines(), tout.splitlines()
    assert len(tl) == len(jl) and tl[0] == jl[0]
    for a, b in zip(tl, jl):
        if " snr=" in b:
            ka, kb = a.split(), b.split()
            assert ka[0] == kb[0] and ka[2:] == kb[2:]
            assert abs(float(ka[1][4:]) - float(kb[1][4:])) <= 0.1 + 1e-9
        else:
            assert a == b
    assert "ChatBox1 <- b'lora test message 0'" in tout and "Decoder0: dropped=0" in tout


def test_topology_runner_errors(capfd, sim_pth):
    rc, _, err = run_cli(trunner.main, [], capfd)
    assert rc == 1 and "Usage" in err
    if not torch.cuda.is_available():
        rc, _, err = run_cli(trunner.main, [f"--file={sim_pth}"], capfd)
        assert rc == 1 and "no CUDA device" in err
    rc, _, _ = run_cli(trunner.main, [f"--file={sim_pth}", "--bogus"], capfd)
    assert rc == 1


@pytest.mark.gpu
def test_topology_on_card_equals_cpu(sim_pth):
    """The graph on the card gives the CPU's messages and counts."""
    from _torch_util import cuda_device

    dev = cuda_device()
    logs = [tfg.load_topology(str(sim_pth), overrides={"SF": 7}, device=d).run(3)
            for d in (dev, "cpu")]
    assert [_msg(o.get("0")) for o in logs[0]["Decoder0"]] == \
        [_msg(o.get("0")) for o in logs[1]["Decoder0"]]
    assert [o.get("dropped") for o in logs[0]["Decoder0"]] == \
        [o.get("dropped") for o in logs[1]["Decoder0"]]
