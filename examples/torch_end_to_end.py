#!/usr/bin/env python3
"""End-to-end walkthrough of the framework's layers on the PyTorch port —
the twin of ``examples/end_to_end.py``, section for section.

Runs on ``--device`` (default the first CUDA card; ``--device=cpu`` for
the CPU):

    python examples/torch_end_to_end.py --device=cpu [--capture=FILE]

The gr-lora_sdr section decodes the capture that ``--capture`` names (the
reference checkout's ``vectors_binary/<CAPTURE_NAME>``); it prints
"(capture not available)" without the flag or where the file is absent,
and reads nothing else. The sharded section runs a mesh of 8 shards of
that device (shards may share one device, as the port's meshes do). The coded chain draws its
noise from a ``torch.Generator`` seeded 0 (the JAX example's from
``PRNGKey(0)``).
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lora_phy_tpu_torch import LoraParams, device_of  # noqa: E402
from lora_phy_tpu_torch.models import coded, modem, stream  # noqa: E402
from lora_phy_tpu_torch.models.coded import CodedConfig  # noqa: E402
from lora_phy_tpu_torch.ops.impair import apply_awgn, apply_cfo_continuous  # noqa: E402

# the gr-lora_sdr OTA capture's name in the reference's vectors_binary/
CAPTURE_NAME = "bw_125k_sf_7_cr_1_ldro_false_crc_true_implheader_false.unknown"


def simple_chain(dev):
    print("== simple Hamming84 chain (the reference's encode/decode) ==")
    p = LoraParams(sf=7)
    payload = np.frombuffer(bytearray(b"hello tpu lora!!"), dtype=np.uint8)
    symbols = modem.encode(payload, device=dev)
    iq = modem.modulate(symbols, p)
    res = modem.demodulate(modem.dechirp(iq, p), p)
    out = modem.decode(res.symbols).cpu().numpy()
    print(f"payload: {payload.tobytes()!r}")
    print(f"decoded: {out.tobytes()!r}  sync=0x{int(res.sync_word):02x}")


def coded_chain(dev):
    print("\n== full coded chain over a noisy channel ==")
    cfg = CodedConfig(sf=8, cr=4)         # CR 4/8, whitening + CRC
    p = LoraParams(sf=8)
    payload = np.frombuffer(bytearray(b"The quick brown fox!"), dtype=np.uint8)
    syms = coded.encode_payload(payload, cfg, device=dev)
    iq = modem.modulate(syms, p)
    gen = torch.Generator(device=dev).manual_seed(0)
    noisy = apply_awgn(gen, modem.dechirp(iq, p), 10.0)
    res = modem.demodulate(noisy, p)
    out, crc_ok, fec_err = coded.decode_payload(res.symbols, len(payload), cfg)
    print(f"decoded: {out.cpu().numpy().tobytes()!r} "
          f"crc_ok={bool(crc_ok.all())} "
          f"fec_corrections={int(fec_err)}")


def streaming(dev):
    print("\n== frame sync over a continuous stream with CFO ==")
    p = LoraParams(sf=7)
    cfg = CodedConfig(sf=7, cr=2)
    payload = np.frombuffer(bytearray(b"frame one"), dtype=np.uint8)
    syms = coded.encode_payload(payload, cfg, device=dev)
    frame = stream.frame_modulate(syms, p)
    sig = torch.cat([
        torch.zeros(777, dtype=torch.complex64, device=dev), frame,
        torch.zeros(1000, dtype=torch.complex64, device=dev)])
    sig = apply_cfo_continuous(sig, 2.0, p.n, p.osr)
    out, sync = stream.frame_demodulate(sig, p, syms.shape[-1])
    print(f"frame found at sample {int(sync.start)} (true 777), "
          f"cfo={int(sync.cfo_bins)} bins (true 2)")
    dec, crc_ok, _ = coded.decode_payload(out.symbols, len(payload), cfg)
    print(f"decoded: {dec.cpu().numpy().tobytes()!r}")


def sharded(dev):
    print("\n== multi-device sharded streaming demod ==")
    from lora_phy_tpu_torch.parallel import mesh as meshlib
    from lora_phy_tpu_torch.parallel.stream import demodulate_stream

    n = 8
    m = meshlib.make_mesh(n_channel=n // 2, n_time=2, devices=[dev] * n)
    p = LoraParams(sf=7)
    payloads = np.tile(np.arange(31, dtype=np.uint8), (n // 2, 1))
    syms = modem.encode(payloads, device=dev)
    dech = modem.dechirp(modem.modulate(syms, p), p)
    sharded_in = meshlib.device_put(dech, meshlib.stream_sharding(m))
    out_syms, sync, cfo, to = demodulate_stream(sharded_in, p, m)
    out = modem.decode(out_syms[..., 2:]).cpu().numpy()
    print(f"mesh {m.shape}: decoded ok={np.array_equal(out, payloads)}")


def wideband(dev):
    print("\n== wideband channelizer: two transmitters, one antenna ==")
    from lora_phy_tpu_torch.ops.channelizer import channelize, synthesize_tone_channels

    p = LoraParams(sf=7)
    k = 4
    pay_a = np.frombuffer(bytearray(b"chan one"), dtype=np.uint8)
    pay_b = np.frombuffer(bytearray(b"chan two"), dtype=np.uint8)
    iq_a = modem.modulate(modem.encode(pay_a, device=dev), p)
    iq_b = modem.modulate(modem.encode(pay_b, device=dev), p)
    sigs = torch.zeros((k, iq_a.numel()), dtype=torch.complex64, device=dev)
    sigs[1], sigs[3] = iq_a, iq_b
    wide = synthesize_tone_channels(sigs, k)
    chans = channelize(wide, k)
    for chan in (1, 3):
        res = modem.demodulate(modem.dechirp(chans[chan] * k, p), p)
        out = modem.decode(res.symbols).cpu().numpy()
        print(f"channel {chan}: {out.tobytes()!r}")


def gr_capture(dev, capture=None):
    print("\n== gr-lora_sdr OTA capture blind decode ==")
    from lora_phy_tpu_torch.models import gr_interop
    from lora_phy_tpu_torch.utils.iqio import read_iq

    if capture is None or not pathlib.Path(capture).exists():
        print("(capture not available)")
        return
    frame = gr_interop.decode_frame(read_iq(capture), LoraParams(sf=7, osr=2),
                                    device=dev)
    print(f"payload: {frame.payload!r} crc_ok={frame.crc_ok} "
          f"header_ok={frame.header_ok} cr=4/{frame.cr+4}")


def main(argv=None) -> int:
    name = capture = None
    for a in (sys.argv[1:] if argv is None else argv):
        if a.startswith("--device="):
            name = a.split("=", 1)[1]
        elif a.startswith("--capture="):
            capture = a.split("=", 1)[1]
        else:
            raise SystemExit(f"unknown flag {a}")
    dev = device_of(None, name)
    simple_chain(dev)
    coded_chain(dev)
    streaming(dev)
    sharded(dev)
    wideband(dev)
    gr_capture(dev, capture)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
