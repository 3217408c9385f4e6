"""Functional block-graph runtime for Pothos ``.pth`` topologies — the
PyTorch twin of ``lora_phy_tpu/models/flowgraph.py``.

The reference ships Pothos GUI topologies (reference:
examples/lora_simulation.pth, lora_sdr_client.pth, lora_sdr_relay.pth,
rx_RN2483.pth — JSON graphs wiring ``/lora/*`` blocks). Here blocks are
functions over whole tensors (one frame of IQ per tick), the graph is a
static DAG run in topological order, and every DSP block calls the port's
pipelines (:mod:`.coded`, :mod:`.stream`, :mod:`.modem`).

Two entry styles:

* programmatic — :class:`Topology` + the ``make_*`` block factories;
* file — :func:`load_topology` parses a Pothos ``.pth`` JSON file
  (globals, blocks, breakers, port and signal/slot connections).

A :class:`Topology` has a device (``device=``, default the first CUDA
card); :meth:`Topology.add` gives it to every block, and the streams
between blocks stay tensors on it. Host values appear where the JAX
twin's block is host code: the noise source draws from numpy's
``RandomState(seed)`` (so both packages add the same noise) and uploads
each burst once; probes capture message bytes and signal values; file
blocks read and write through :mod:`..utils.iqio`. Symbols are int32
where the JAX twin has uint16.

Pothos semantics kept: breaker nodes are named virtual wires
(``nodeName``); signal→slot edges (``sigSlots``) deliver values to slots
before the destination's next tick; GUI widgets/plotters become recording
probes.
"""

from __future__ import annotations

import ast
import cmath
import json
import math
import operator
import re
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from .. import LoraParams, device_of
from . import coded, modem, stream
from .coded import CodedConfig

# ---------------------------------------------------------------------------
# Core graph runtime
# ---------------------------------------------------------------------------


@dataclass
class Block:
    """A node: ``fn(block, inputs) -> outputs`` over whole-tensor messages.

    ``inputs``/``outputs`` map port name -> value; ``None`` means "no
    message this tick" and downstream blocks see the port as absent.
    Signals are ordinary output ports listed in ``signal_ports``; slots are
    set via :meth:`set_slot` and read from ``block.slots``. ``device`` is
    set by :meth:`Topology.add` (sources create their tensors there).
    """

    name: str
    fn: Callable[["Block", dict], dict]
    signal_ports: tuple = ()
    state: dict = field(default_factory=dict)
    slots: dict = field(default_factory=dict)
    captured: list = field(default_factory=list)
    device: torch.device | None = None

    def set_slot(self, slot: str, value) -> None:
        self.slots[slot] = value


class Topology:
    """Static DAG of blocks on one device; :meth:`run` executes N ticks in
    topological order."""

    def __init__(self, device=None):
        self.device = device_of(None, device)
        self.blocks: dict[str, Block] = {}
        self.wires: list[tuple[str, str, str, str]] = []   # src, port, dst, port
        self.signal_wires: list[tuple[str, str, str, str]] = []  # src, sig, dst, slot

    def add(self, block: Block) -> Block:
        if block.name in self.blocks:
            raise ValueError(f"duplicate block {block.name!r}")
        block.device = self.device
        self.blocks[block.name] = block
        return block

    def connect(self, src: str, src_port: str, dst: str, dst_port: str) -> None:
        self.wires.append((src, src_port, dst, dst_port))

    def connect_signal(self, src: str, signal: str, dst: str, slot: str) -> None:
        self.signal_wires.append((src, signal, dst, slot))

    def _order(self) -> list[str]:
        deps = {n: set() for n in self.blocks}
        for src, _, dst, _ in self.wires:
            if src in deps and dst in deps:
                deps[dst].add(src)
        order, seen = [], set()

        def visit(n, chain=()):
            if n in seen:
                return
            if n in chain:
                raise ValueError(f"cycle through {n!r}")
            for d in sorted(deps[n]):
                visit(d, chain + (n,))
            seen.add(n)
            order.append(n)

        for n in sorted(self.blocks):
            visit(n)
        return order

    def run(self, ticks: int = 1) -> dict[str, list]:
        """Execute the graph; returns {block: [outputs-per-tick]}."""
        order = self._order()
        log: dict[str, list] = {n: [] for n in order}
        for _ in range(ticks):
            port_vals: dict[tuple[str, str], Any] = {}
            for name in order:
                block = self.blocks[name]
                inputs = {}
                for src, sport, dst, dport in self.wires:
                    if dst == name and (src, sport) in port_vals:
                        v = port_vals[(src, sport)]
                        if v is not None:
                            inputs[dport] = v
                outputs = block.fn(block, inputs) or {}
                log[name].append(outputs)
                for port, v in outputs.items():
                    port_vals[(name, port)] = v
                for src, sig, dst, slot in self.signal_wires:
                    if src == name and sig in outputs and outputs[sig] is not None:
                        if dst in self.blocks:
                            self.blocks[dst].set_slot(slot, outputs[sig])
        return log


# ---------------------------------------------------------------------------
# Block library (the /lora, /comms, /blocks vocabulary of the .pth files)
# ---------------------------------------------------------------------------


def make_test_gen(name: str = "test_gen") -> Block:
    """Deterministic message source: ``b"lora test message N"`` per tick
    (the upstream TestGen's role), as a uint8 tensor on the block's device."""

    def fn(block, inputs):
        i = block.state.setdefault("count", 0)
        block.state["count"] = i + 1
        msg = np.frombuffer(b"lora test message %d" % i, np.uint8)
        return {"0": torch.from_numpy(msg.copy()).to(block.device)}

    return Block(name, fn)


def make_pacer(name: str = "pacer") -> Block:
    """Rate limiter upstream; a pure pass-through here (graph ticks pace)."""
    return Block(name, lambda block, inputs: dict(inputs))


def make_encoder(name: str, cfg: CodedConfig, explicit: bool = True) -> Block:
    """payload bytes -> coded chirp-bin symbols (+ explicit header)."""

    def fn(block, inputs):
        payload = inputs.get("0")
        if payload is None:
            return {}
        payload = torch.as_tensor(payload, device=block.device).to(torch.uint8)
        body = coded.encode_payload(payload, cfg)
        if explicit:
            hdr = coded.encode_header(payload.shape[-1], cfg, device=payload.device)
            body = torch.cat([hdr, body])
        return {"0": body}

    return Block(name, fn)


def make_modulator(name: str, params: LoraParams, ampl: float = 1.0,
                   padding: int = 0, preamble_len: int = 8) -> Block:
    """symbols -> one framed IQ burst (preamble + sync + 2.25 down + data),
    optionally zero-padded (the Pothos block's ``padding`` property)."""

    def fn(block, inputs):
        syms = inputs.get("0")
        if syms is None:
            return {}
        syms = torch.as_tensor(syms, device=block.device).to(torch.int32)
        iq = stream.frame_modulate(syms, params, preamble_len=preamble_len,
                                   amplitude=ampl)
        if padding:
            pad = torch.zeros(padding * params.step, dtype=torch.complex64,
                              device=iq.device)
            iq = torch.cat([pad, iq, pad])
        return {"0": iq}

    return Block(name, fn)


def make_noise_source(name: str, ampl: float = 0.0, seed: int = 0) -> Block:
    """Complex AWGN burst source; amplitude settable via ``setAmplitude``.
    The draws are numpy's ``RandomState(seed)`` (the JAX twin's), uploaded
    once per burst."""

    def fn(block, inputs):
        a = float(block.slots.get("setAmplitude", ampl))
        n = int(block.slots.get("setLength", block.state.get("length", 0)))
        if n == 0:
            return {"0": None, "ampl": a}
        rng = block.state.setdefault("rng", np.random.RandomState(seed))
        z = torch.from_numpy(rng.randn(2, n).astype(np.float32)
                             * np.float32(a / math.sqrt(2.0))).to(block.device)
        return {"0": torch.complex(z[0], z[1]), "ampl": a}

    return Block(name, fn, signal_ports=("ampl",))


def make_arithmetic(name: str, operation: str = "ADD") -> Block:
    """Elementwise combine of all input ports (zero-padded to the longest)."""

    ops = {"ADD": torch.add, "SUB": torch.sub, "MUL": torch.mul}
    op = ops[operation]

    def fn(block, inputs):
        vals = [torch.as_tensor(inputs[k], device=block.device)
                for k in sorted(inputs) if inputs[k] is not None]
        if not vals:
            return {}
        n = max(v.shape[-1] for v in vals)
        acc = None
        for v in vals:
            if v.shape[-1] < n:
                v = torch.cat([v, v.new_zeros(n - v.shape[-1])])
            acc = v if acc is None else op(acc, v)
        return {"0": acc}

    return Block(name, fn)


def make_rotate(name: str, phase: float = 0.0) -> Block:
    """Constant phase rotation ``x * exp(j*phase)`` (channel rotation), in
    complex128 then rounded to complex64, as numpy computes the twin's."""

    def fn(block, inputs):
        x = inputs.get("0")
        if x is None:
            return {}
        x = torch.as_tensor(x, device=block.device)
        rot = x.to(torch.complex128) * cmath.exp(1j * phase)
        return {"0": rot.to(torch.complex64)}

    return Block(name, fn)


def make_dc_removal(name: str) -> Block:
    def fn(block, inputs):
        x = inputs.get("0")
        if x is None:
            return {}
        x = torch.as_tensor(x, device=block.device)
        return {"0": (x - x.mean()).to(x.dtype)}

    return Block(name, fn)


def make_freq_demod(name: str) -> Block:
    """Instantaneous frequency: angle of the one-sample conjugate product."""

    def fn(block, inputs):
        x = inputs.get("0")
        if x is None:
            return {}
        x = torch.as_tensor(x, device=block.device)
        return {"0": torch.angle(x[..., 1:] * torch.conj(x[..., :-1]))}

    return Block(name, fn)


def make_demodulator(name: str, params: LoraParams, preamble_len: int = 8,
                     thresh_db: float | None = -30.0) -> Block:
    """Continuous IQ burst -> demodulated symbol bins.

    The sync scan (:func:`.stream.frame_sync`) locates the frame; its
    payload rides the dechirped demod path (:func:`.stream.
    frame_demodulate`). Ports: ``0`` = symbol bins (sync symbols stripped),
    ``raw`` = the input tap, ``dec`` = dechirped payload tap. Signals:
    ``error`` = integer-CFO estimate in bins, ``snr`` = dB (payload peak
    against mean bin power, on the device, one host read).
    ``thresh_db`` is the Pothos block's ``thresh`` detection threshold.
    """

    def fn(block, inputs):
        iq = inputs.get("0")
        if iq is None:
            return {}
        iq = torch.as_tensor(iq, device=block.device).to(torch.complex64)
        step = params.step
        res = stream.frame_sync(iq, params, preamble_len, min_power_db=thresh_db)
        if not res.found:
            return {"raw": iq}
        avail = (iq.shape[-1] - res.payload_start) // step
        if avail < 1:
            return {"raw": iq}
        out, _ = stream.frame_demodulate(iq, params, int(avail), preamble_len,
                                         min_power_db=thresh_db, sync_result=res)
        if out is None:
            return {"raw": iq}
        pay = iq[res.payload_start: res.payload_start + avail * step]
        dech = modem.dechirp(pay, params)
        spec = torch.fft.fft(dech[: avail * step].reshape(avail, step)[:, ::params.osr],
                             dim=-1).abs() ** 2
        peak = spec.amax(dim=-1)
        noise = (spec.sum(dim=-1) - peak) / (spec.shape[-1] - 1)
        ratio = peak.mean() / torch.clamp(noise.mean(), min=1e-12)
        snr_db = float(10.0 * torch.log10(ratio))
        return {
            "0": out.symbols,
            "raw": iq, "dec": dech,
            "error": int(res.cfo_bins), "snr": snr_db,
        }

    return Block(name, fn, signal_ports=("error", "snr"))


def make_decoder(name: str, cfg: CodedConfig, explicit: bool = True) -> Block:
    """symbol bins -> payload bytes; counts CRC/header drops (``dropped``)."""

    def fn(block, inputs):
        bins = inputs.get("0")
        if bins is None:
            return {}
        bins = torch.as_tensor(bins, device=block.device)
        block.state.setdefault("dropped", 0)
        use = cfg
        body = bins
        if explicit:
            if bins.shape[-1] < 8:
                block.state["dropped"] += 1
                return {"dropped": block.state["dropped"]}
            nbytes, cr, crc_en, ok = coded.decode_header(bins[:8], cfg.sf)
            if not ok or not (1 <= cr <= 4) or nbytes == 0:
                block.state["dropped"] += 1
                return {"dropped": block.state["dropped"]}
            use = CodedConfig(sf=cfg.sf, cr=cr, ldro=cfg.ldro, crc=crc_en,
                              whiten=cfg.whiten)
            body = bins[8:]
            length = nbytes
        else:
            length = block.slots.get("setLength", block.state.get("length"))
            if length is None:
                raise ValueError("implicit decoder needs a payload length")
        nsym = coded.payload_symbol_count(int(length), use)
        if body.shape[-1] < nsym:
            block.state["dropped"] += 1
            return {"dropped": block.state["dropped"]}
        payload, crc_ok, _ = coded.decode_payload(body[:nsym], int(length), use)
        if use.crc and not bool(crc_ok.all()):
            block.state["dropped"] += 1
            return {"dropped": block.state["dropped"]}
        return {"0": payload, "dropped": block.state["dropped"]}

    return Block(name, fn, signal_ports=("dropped",))


def _captured(v):
    """A probe's record of one input: a uint8 tensor (a message) as bytes,
    other tensors as they are (on the device), host values unchanged."""
    if isinstance(v, torch.Tensor) and v.dtype == torch.uint8:
        return v.cpu().numpy().tobytes()
    return v


def make_probe(name: str) -> Block:
    """Recording sink standing in for every GUI widget/plotter block."""

    def fn(block, inputs):
        if inputs:
            block.captured.append({k: _captured(v) for k, v in inputs.items()})
        if block.slots:
            block.captured.append({"slots": dict(block.slots)})
            block.slots = {}
        return {}

    return Block(name, fn)


# --- safe expression evaluation -------------------------------------------
# .pth files come from arbitrary (untrusted) sources; a raw eval() with
# stripped builtins is escapable via attribute traversal. Pothos property
# expressions only need literals, names, arithmetic/bit/compare operators
# and a couple of math calls, so evaluate the AST under a strict node
# whitelist instead (the JAX twin's whitelist, copied).

_SAFE_BINOPS = {
    ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
    ast.Div: operator.truediv, ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod, ast.Pow: operator.pow,
    ast.LShift: operator.lshift, ast.RShift: operator.rshift,
    ast.BitOr: operator.or_, ast.BitAnd: operator.and_,
    ast.BitXor: operator.xor,
}
_SAFE_UNARY = {ast.UAdd: operator.pos, ast.USub: operator.neg,
               ast.Invert: operator.invert, ast.Not: operator.not_}
_SAFE_CMP = {ast.Eq: operator.eq, ast.NotEq: operator.ne,
             ast.Lt: operator.lt, ast.LtE: operator.le,
             ast.Gt: operator.gt, ast.GtE: operator.ge}
_SAFE_CALLS = {
    "pow": pow, "abs": abs, "min": min, "max": max, "int": int,
    "float": float, "round": round, "len": len,
}
_SAFE_MATH = {n: getattr(math, n) for n in (
    "sin", "cos", "tan", "sqrt", "log", "log2", "log10", "exp",
    "floor", "ceil", "atan2", "hypot", "pi", "e")}


def safe_eval(expr: str, env: dict | None = None):
    """Evaluate a Pothos property/evaluator expression without ``eval``.

    Supports literals (incl. hex), tuples/lists, names from ``env``,
    ``math.<fn>``, arithmetic / bitwise / comparison / boolean operators,
    conditional expressions, and a whitelist of pure calls. Anything else
    (attribute traversal, subscript-of-arbitrary-object tricks,
    comprehensions, lambdas…) raises ``ValueError``.
    """
    env = env or {}

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            if node.id == "pi":
                return env.get("pi", math.pi)
            if node.id == "math":
                raise ValueError("bare 'math' reference")
            if node.id in env:
                return env[node.id]
            raise ValueError(f"unknown name {node.id!r}")
        if isinstance(node, ast.BinOp) and type(node.op) in _SAFE_BINOPS:
            return _SAFE_BINOPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _SAFE_UNARY:
            return _SAFE_UNARY[type(node.op)](ev(node.operand))
        if isinstance(node, ast.BoolOp):
            # lazy, like Python's and/or: a guard such as
            # ``SF == 0 or 10/SF > 1`` must not evaluate the division
            is_and = isinstance(node.op, ast.And)
            out = ev(node.values[0])
            for v in node.values[1:]:
                if is_and and not out:
                    return out
                if not is_and and out:
                    return out
                out = ev(v)
            return out
        if isinstance(node, ast.Compare):
            left = ev(node.left)
            for op, comp in zip(node.ops, node.comparators):
                if type(op) not in _SAFE_CMP:
                    raise ValueError("unsupported comparison")
                right = ev(comp)
                if not _SAFE_CMP[type(op)](left, right):
                    return False
                left = right
            return True
        if isinstance(node, ast.IfExp):
            return ev(node.body) if ev(node.test) else ev(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            vals = [ev(e) for e in node.elts]
            return tuple(vals) if isinstance(node, ast.Tuple) else vals
        if isinstance(node, ast.Dict):
            if any(k is None for k in node.keys):
                raise ValueError("dict unpacking not supported")
            return {ev(k): ev(v) for k, v in zip(node.keys, node.values)}
        if isinstance(node, ast.Attribute):
            # value access: math.pi / math.e are plain attribute reads
            if (isinstance(node.value, ast.Name) and node.value.id == "math"
                    and node.attr in _SAFE_MATH):
                return _SAFE_MATH[node.attr]
            raise ValueError(f"unsupported attribute {node.attr!r}")
        if isinstance(node, ast.Call):
            if node.keywords:
                raise ValueError("keyword args not supported")
            f = node.func
            if isinstance(f, ast.Name) and f.id in _SAFE_CALLS:
                fn = _SAFE_CALLS[f.id]
            elif (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                  and f.value.id == "math" and f.attr in _SAFE_MATH):
                fn = _SAFE_MATH[f.attr]
            else:
                raise ValueError("call not in whitelist")
            if not callable(fn):
                raise ValueError(f"{f.attr!r} is not callable")
            return fn(*[ev(a) for a in node.args])
        raise ValueError(f"unsupported expression node {type(node).__name__}")

    return ev(ast.parse(expr, mode="eval"))


def make_evaluator(name: str, expr: str, var_names: tuple = ()) -> Block:
    """Re-evaluates ``expr`` from slot-fed variables (``setX`` -> ``x``);
    emits signal ``triggered``. Mirrors /blocks/evaluator."""

    def fn(block, inputs):
        env = {"pi": math.pi}
        for v in var_names:
            slot = "set" + v[0].upper() + v[1:]
            if slot not in block.slots and v not in block.state:
                return {}
            if slot in block.slots:
                block.state[v] = block.slots[slot]
            env[v] = block.state[v]
        return {"triggered": safe_eval(expr, env)}

    return Block(name, fn, signal_ports=("triggered",))


def make_constant(name: str, value) -> Block:
    """Widget with an initial value: emits ``valueChanged`` once."""

    def fn(block, inputs):
        if block.state.get("sent"):
            return {}
        block.state["sent"] = True
        return {"valueChanged": value}

    return Block(name, fn, signal_ports=("valueChanged",))


def make_iq_file_source(name: str, path: str, chunk: int | None = None) -> Block:
    """The file's IQ (float32 pairs), uploaded once, in ``chunk``-sample
    messages (the whole file in one without ``chunk``)."""
    from ..utils import iqio

    def fn(block, inputs):
        if "data" not in block.state:
            block.state["data"] = torch.from_numpy(iqio.read_iq(path)).to(block.device)
            block.state["pos"] = 0
        data, pos = block.state["data"], block.state["pos"]
        if pos >= data.shape[-1]:
            return {}
        n = chunk or data.shape[-1]
        block.state["pos"] = pos + n
        return {"0": data[pos: pos + n]}

    return Block(name, fn)


def make_iq_file_sink(name: str, path: str) -> Block:
    from ..utils import iqio

    def fn(block, inputs):
        x = inputs.get("0")
        if x is not None:
            # append-only (a long stream would otherwise rewrite the whole
            # growing file every tick and retain every chunk in memory)
            mode = "ab" if block.state.get("started") else "wb"
            block.state["started"] = True
            iqio.append_iq(path, torch.as_tensor(x).cpu().numpy(), mode=mode)
        return {}

    return Block(name, fn)


# ---------------------------------------------------------------------------
# Pothos .pth loader
# ---------------------------------------------------------------------------

_CR_NAMES = {"4/5": 1, "4/6": 2, "4/7": 3, "4/8": 4}


def _eval_prop(text: str, env: dict):
    """Evaluate a Pothos property expression (globals, hex, shifts, pi)."""
    text = text.strip()
    if re.fullmatch(r'"[^"]*"', text):
        return text[1:-1]
    return safe_eval(text, dict(env, pi=math.pi))


def _sf_params(props: dict, env: dict, sync_default: int = 0x12) -> LoraParams:
    sf = int(_eval_prop(props.get("sf", "7"), env))
    sync = props.get("sync")
    sync = int(_eval_prop(sync, env)) if sync else sync_default
    osr = int(_eval_prop(props.get("ovs", "1"), env))
    return LoraParams(sf=sf, osr=osr, sync_word=sync)


def load_topology(path: str, seed: int = 0,
                  overrides: dict | None = None, device=None) -> Topology:
    """Build a runnable :class:`Topology` on ``device`` (default: the first
    CUDA card) from a Pothos ``.pth`` file.

    ``overrides`` replaces entries of the file's ``globals`` list (e.g.
    ``{"SF": 7}``). Disabled blocks and connections are skipped. GUI
    widget/plotter blocks and ``/sdr/*`` devices become recording probes.
    """
    with open(path) as f:
        doc = json.load(f)
    env: dict = {}
    for g in doc.get("globals", []):
        env[g["name"]] = _eval_prop(g["value"], env)
    if overrides:
        env.update(overrides)

    topo = Topology(device)
    breakers: dict[str, str] = {}          # breaker object id -> net name
    nets: dict[str, list] = {}             # net name -> [(kind, id, port)]
    sync_word = env.get("SYNC", 0x12)

    blocks_json, conns = [], []
    for page in doc.get("pages", []):
        for obj in page.get("graphObjects", []):
            if not obj.get("enabled", True):
                # Pothos disables blocks/connections in place (the shipped
                # lora_sdr_relay.pth disables its TestGen/Pacer sources —
                # a relay must only retransmit, not originate traffic)
                continue
            what = obj.get("what")
            if what == "Block":
                blocks_json.append(obj)
            elif what == "Breaker":
                breakers[obj["id"]] = obj["nodeName"]
            elif what == "Connection":
                conns.append(obj)

    for obj in blocks_json:
        bid, bpath = obj["id"], obj.get("path", "")
        props = {p["key"]: p["value"] for p in obj.get("properties", [])}
        if bpath == "/lora/test_gen":
            topo.add(make_test_gen(bid))
        elif bpath == "/blocks/pacer":
            topo.add(make_pacer(bid))
        elif bpath == "/lora/lora_encoder":
            cfg = CodedConfig(
                sf=int(_eval_prop(props.get("sf", "7"), env)),
                cr=_CR_NAMES[_eval_prop(props.get("cr", '"4/8"'), env)],
                crc=bool(_eval_prop(props.get("crc", "true").title(), env)),
                whiten=bool(_eval_prop(props.get("whitening", "true").title(), env)),
            )
            explicit = bool(_eval_prop(props.get("explicit", "true").title(), env))
            topo.add(make_encoder(bid, cfg, explicit))
        elif bpath == "/lora/lora_mod":
            params = _sf_params(props, env, sync_word)
            topo.add(make_modulator(
                bid, params,
                ampl=float(_eval_prop(props.get("ampl", "1.0"), env)),
                padding=int(_eval_prop(props.get("padding", "0"), env)),
            ))
        elif bpath == "/lora/lora_demod":
            topo.add(make_demodulator(
                bid, _sf_params(props, env, sync_word),
                thresh_db=float(_eval_prop(props.get("thresh", "-30.0"), env)),
            ))
        elif bpath == "/lora/lora_decoder":
            cfg = CodedConfig(
                sf=int(_eval_prop(props.get("sf", "7"), env)),
                cr=_CR_NAMES[_eval_prop(props.get("cr", '"4/8"'), env)],
                whiten=bool(_eval_prop(props.get("whitening", "true").title(), env)),
            )
            explicit = bool(_eval_prop(props.get("explicit", "true").title(), env))
            dec = make_decoder(bid, cfg, explicit)
            if not explicit and "dataLength" in props:
                # implicit-header decoders carry their payload length as a
                # block property in the .pth file
                dec.state["length"] = int(_eval_prop(props["dataLength"], env))
            topo.add(dec)
        elif bpath == "/comms/noise_source":
            topo.add(make_noise_source(
                bid, ampl=float(_eval_prop(props.get("ampl", "0.0"), env)),
                seed=seed))
        elif bpath == "/comms/arithmetic":
            topo.add(make_arithmetic(
                bid, _eval_prop(props.get("operation", '"ADD"'), env)))
        elif bpath == "/comms/rotate":
            topo.add(make_rotate(
                bid, phase=float(_eval_prop(props.get("phase", "0.0"), env))))
        elif bpath == "/comms/dc_removal":
            topo.add(make_dc_removal(bid))
        elif bpath == "/comms/freq_demod":
            topo.add(make_freq_demod(bid))
        elif bpath == "/blocks/evaluator":
            vars_ = tuple(_eval_prop(v, env) if v.startswith('"') else v
                          for v in json.loads(props.get("vars", "[]")
                                              .replace("'", '"')))
            topo.add(make_evaluator(
                bid, _eval_prop(props.get("expr", '"0"'), env), vars_))
        elif bpath == "/widgets/numeric_entry":
            topo.add(make_constant(
                bid, float(_eval_prop(props.get("value", "0"), env))))
        else:
            # plotters, chat boxes, displays, /sdr devices: recording probes
            topo.add(make_probe(bid))

    mod_blocks = [o["id"] for o in blocks_json if o.get("path") == "/lora/lora_mod"]

    def resolve(obj_id: str, port: str):
        if obj_id in breakers:
            return ("net", breakers[obj_id], port)
        return ("block", obj_id, port)

    pending: list[tuple] = []
    for c in conns:
        if "sigSlots" in c:
            src = c.get("signalId"), c.get("slotId")
            for sig, slot in c["sigSlots"]:
                if src[0] in topo.blocks and src[1] in topo.blocks:
                    topo.connect_signal(src[0], sig, src[1], slot)
            continue
        s = resolve(c["outputId"], c.get("outputKey", "0"))
        d = resolve(c["inputId"], c.get("inputKey", "0"))
        if s[0] == "net" or d[0] == "net":
            if s[0] == "net":
                nets.setdefault(s[1], []).append(("dst_of_net", d))
            if d[0] == "net":
                nets.setdefault(d[1], []).append(("src_of_net", s))
        else:
            pending.append((s[1], s[2], d[1], d[2]))

    for name, ends in nets.items():
        srcs = [e for kind, e in ends if kind == "src_of_net" and e[0] == "block"]
        dsts = [e for kind, e in ends if kind == "dst_of_net" and e[0] == "block"]
        for _, sid, sport in srcs:
            for _, did, dport in dsts:
                pending.append((sid, sport, did, dport))

    for sid, sport, did, dport in pending:
        if sid in topo.blocks and did in topo.blocks:
            topo.connect(sid, sport, did, dport)

    # drive noise-burst length from the modulator's worst-case frame size
    # (the Pothos stream model pulls equal-rate streams; in the whole-array
    # model the adder pads the shorter input, so a length upper bound works)
    for bid in mod_blocks:
        obj = next(o for o in blocks_json if o["id"] == bid)
        props = {p["key"]: p["value"] for p in obj.get("properties", [])}
        params = _sf_params(props, env, sync_word)
        pad = int(_eval_prop(props.get("padding", "0"), env))
        mtu = int(env.get("MTU", 32))
        worst = coded.payload_symbol_count(mtu + 8, CodedConfig(sf=params.sf, cr=4))
        length = (stream.frame_overhead_samples(params)
                  + (8 + worst) * params.step + 2 * pad * params.step)
        for nb in topo.blocks.values():
            if nb.fn.__qualname__.startswith("make_noise_source"):
                nb.state["length"] = length
    return topo
