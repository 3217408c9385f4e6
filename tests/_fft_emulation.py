"""The FFT of the hand kernels that take one per row above N = 16
(``csrc/scan.cu``, ``csrc/decide.cu``), emulated in numpy float32 stage
for stage: the same passes, index maps and twiddles, so that a CPU test
can hold the kernels' bins to their twins' outside near-ties."""

import numpy as np

from lora_phy_tpu_torch.ops.fused_demod import _twiddles


def _bit_reverse(v, bits):
    return int(format(v, f"0{bits}b")[::-1], 2) if bits else 0


def _dif(re_, im_, w):
    """In-place radix-2 DIF FFT over the last axis (fft_rows.cuh fft_dif);
    ``w[e]`` = (cos, -sin) of W_M^e. Position p then holds bin
    bit_reverse(p)."""
    m = re_.shape[-1]
    half = m // 2
    while half >= 1:
        for blk in range(m // (2 * half)):
            for i in range(half):
                a = 2 * half * blk + i
                b = a + half
                e = i * (m // (2 * half))
                dr, di = re_[..., a] - re_[..., b], im_[..., a] - im_[..., b]
                re_[..., a] += re_[..., b]
                im_[..., a] += im_[..., b]
                if e == 0:
                    re_[..., b], im_[..., b] = dr, di
                elif 4 * e == m:
                    re_[..., b], im_[..., b] = di, -dr
                else:
                    wr, wi = w[e]
                    re_[..., b] = dr * wr - di * wi
                    im_[..., b] = dr * wi + di * wr
        half //= 2


def _natural(re_, im_, bits):
    """Positions of a bit-reversed DIF output, last axis, in bin order."""
    order = [_bit_reverse(p, bits) for p in range(re_.shape[-1])]
    nr, ni = np.empty_like(re_), np.empty_like(im_)
    nr[..., order], ni[..., order] = re_, im_
    return nr, ni


def _twiddle(re_, im_, w):
    return re_ * w[..., 0] - im_ * w[..., 1], re_ * w[..., 1] + im_ * w[..., 0]


def kernel_power(xr, xi):
    """|X|² in natural bin order of [W, N] windows as csrc/scan.cu and
    csrc/decide.cu take them: one N-point FFT at N <= 16; at N = 32..128 a 16-point FFT over
    j of samples t + G*j, the twiddles W_N^(t*k1), G-point FFTs over t;
    at N = 256..4096 a 16-point FFT over j of samples t + M*j, the
    twiddles W_N^(t*k1), a 16-point FFT over tb of y[ta + L*tb], the
    twiddles W_M^(ta*c), L-point FFTs over ta, bin k1 + 16*c + 256*d."""
    w, n = xr.shape
    tw = _twiddles(n)
    if n <= 16:
        re_, im_ = xr.copy(), xi.copy()
        _dif(re_, im_, tw)
        re_, im_ = _natural(re_, im_, n.bit_length() - 1)
        return re_ * re_ + im_ * im_
    m = n // 16                                             # threads a window
    # pass 1: [W, t, j], thread t holds sample t + m*j
    re_ = xr.reshape(w, 16, m).transpose(0, 2, 1).copy()
    im_ = xi.reshape(w, 16, m).transpose(0, 2, 1).copy()
    _dif(re_, im_, tw[::m])
    re_, im_ = _natural(re_, im_, 4)                        # [W, t, k1]
    re_, im_ = _twiddle(re_, im_, tw[np.outer(np.arange(m), np.arange(16))])
    if n <= 128:
        # G-point FFTs over t: [W, k1, t]
        re_, im_ = re_.transpose(0, 2, 1).copy(), im_.transpose(0, 2, 1).copy()
        _dif(re_, im_, tw[::16])
        re_, im_ = _natural(re_, im_, m.bit_length() - 1)   # [W, k1, k2]
        mag = re_ * re_ + im_ * im_
        return mag.transpose(0, 2, 1).reshape(w, n)         # bin k1 + 16*k2
    el = m // 16
    # pass 2: t = ta + el*tb -> [W, k1, ta, tb]
    re_ = re_.reshape(w, 16, el, 16).transpose(0, 3, 2, 1).copy()
    im_ = im_.reshape(w, 16, el, 16).transpose(0, 3, 2, 1).copy()
    _dif(re_, im_, tw[::m])
    re_, im_ = _natural(re_, im_, 4)                        # [W, k1, ta, c]
    re_, im_ = _twiddle(re_, im_, tw[16 * np.outer(np.arange(el), np.arange(16))])
    if el > 1:
        # pass 3: [W, k1, c, ta], L-point FFTs over ta
        re_, im_ = re_.transpose(0, 1, 3, 2).copy(), im_.transpose(0, 1, 3, 2).copy()
        _dif(re_, im_, tw[:: n // el])
        re_, im_ = _natural(re_, im_, el.bit_length() - 1)  # [W, k1, c, d]
    else:
        re_, im_ = re_[:, :, 0, :, None], im_[:, :, 0, :, None]
    mag = re_ * re_ + im_ * im_
    return mag.transpose(0, 3, 2, 1).reshape(w, n)          # bin k1 + 16*c + 256*d
