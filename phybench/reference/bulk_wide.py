"""Plain reference of the wide bulk coded decoder (``paths/bulk_wide.py``):
the reference of :mod:`.bulk`, the same steps in the same precisions,
computed in blocks of at most :data:`BLOCK` frames. At N = 4096 a frame
is 32 windows of 4,096 samples, and one block of :mod:`.bulk`'s 4,096
frames would hold tens of GB in float64 beside the program's cached
memory; 512 frames hold a few.

Nothing here imports the program; the inputs are the benchmark's.
"""

from __future__ import annotations

import numpy as np

from . import bulk
from .bulk import decode, truth_summary  # noqa: F401

BLOCK = 512


def demodulate(xr, xi, config, precision):
    """:func:`.bulk.demodulate` in blocks of :data:`BLOCK` frames."""
    return bulk.demodulate(xr, xi, config, precision, chunk=BLOCK)


def estimates(xr, xi, config, precision):
    """(cfo [F], time_offset [F]) of [F, L] raw frames: steps 1-3 of
    :mod:`.bulk` (dechirp, scale, offsets from the sync pair) in
    ``precision``, in blocks of :data:`BLOCK` frames."""
    n = 1 << config["sf"]
    cfo, t_off = [], []
    for a in range(0, xr.shape[0], BLOCK):
        yr, yi = bulk._windows(xr[a:a + BLOCK], xi[a:a + BLOCK], n, precision)
        _, c, t = bulk.offsets(yr, yi, n, precision)
        cfo.append(c.cpu().numpy().astype(np.float64))
        t_off.append(t.cpu().numpy().astype(np.float64))
    return np.concatenate(cfo), np.concatenate(t_off)


def reference_outputs(item, config) -> dict:
    """The reference's float64 outputs for one pool item, frames flattened,
    and its own estimates computed in float32 (``cfo_f32``,
    ``time_offset_f32``)."""
    xr = item.xr.reshape(-1, item.xr.shape[-1])
    xi = item.xi.reshape(-1, item.xi.shape[-1])
    ref = demodulate(xr, xi, config, "f64")
    ref["cfo_f32"], ref["time_offset_f32"] = estimates(xr, xi, config, "f32")
    return ref


def judge(item, out: dict, ref: dict, config: dict, precision: str = "f64") -> dict:
    """:func:`.bulk.judge` (the numbers and what each means) in blocks of
    :data:`BLOCK` frames, and two more:

    ``cfo_err_f32``, ``to_err_f32``  the mean over every frame of the
        calls of the difference between the program's CFO (bins) and
        timing offset (samples) and the reference's own estimates
        computed in float32 (TF32 off).

    At N = 4096 both estimates come from the sync pair's mean peak bin, a
    number up to 4,096 held in float32, whose unit in the last place
    (3.05e-5 bins at 256-512, 0.125 samples of the timing offset) is
    larger than the error of TF32 arithmetic there. Against the float64
    estimates that representation sets the error of any float32
    computation, sound or not (``cfo_err``, ``to_err``). Against the
    float32 estimates, exact float32 arithmetic by another route (another
    DFT, another summation order) lands on the same float in all but a
    few frames, where its rounding carries the mean peak bin across a
    rounding boundary; TF32 arithmetic does so in many, each by a unit in
    the last place."""
    numbers = bulk.judge(item, out, ref, config, precision, chunk=BLOCK)
    frames = numbers["cfo_err"].size
    for k, key in (("cfo", "cfo"), ("to", "time_offset")):
        err = np.abs(out[key].reshape(-1) - ref[f"{key}_f32"])
        numbers[f"{k}_err_f32"] = (float(err.sum()), frames)
    return numbers


class System(bulk.System):
    """The reference in the program's place (the control): the same
    calls, computed in ``precision``, in blocks of :data:`BLOCK` frames."""

    def device(self, item):
        shape = item.xr.shape[:-1]
        r = demodulate(item.xr.reshape(-1, item.xr.shape[-1]),
                       item.xi.reshape(-1, item.xi.shape[-1]), self.config, self.precision)
        pay, ok, fec = decode(r["symbols"], self.config)
        r.update(bytes=pay, crc_ok=ok, fec_errors=fec)
        return {k: v.reshape(*shape, *v.shape[1:]) for k, v in r.items()}
