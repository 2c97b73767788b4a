"""H.264 inter-prediction sample interpolation (spec 8.4.2.2).

The port's copy of ``mixlab_tpu/av/h264mc.py``.

Pure-numpy fractional-sample motion compensation for the zero-dep
decoder tier (av/h264dec.py P-slice support):

  * ``luma_mc``   — quarter-sample luma interpolation: the 6-tap
    (1, -5, 20, 20, -5, 1) half-sample filter of 8.4.2.2.1 plus the
    quarter-sample averages, with unrestricted-MV edge clamping,
  * ``chroma_mc`` — eighth-sample bilinear chroma interpolation
    (8.4.2.2.2, 4:2:0),
  * ``weight_pred`` — explicit weighted-prediction application for P
    slices (8.4.2.3.2).

The reference decodes inter H.264 via ffmpeg FFI
(src/rtmp/mod.rs:260-338); these routines exist so the
zero-dependency build can ingest real (inter-coded) RTMP video.  Each
function is differentially validated bit-exact against libavcodec
through tests/test_h264dec_inter.py on real x264 streams.
"""

from __future__ import annotations

import numpy as np


def _gather(plane: np.ndarray, y0: int, x0: int, h: int, w: int) -> np.ndarray:
    """Full-sample fetch with edge clamping (unrestricted MVs reference
    samples outside the picture as the nearest edge sample, 8.4.2.2.1
    Clip3 on the sample coordinates)."""
    ph, pw = plane.shape
    ys = np.clip(np.arange(y0, y0 + h), 0, ph - 1)
    xs = np.clip(np.arange(x0, x0 + w), 0, pw - 1)
    return plane[np.ix_(ys, xs)].astype(np.int64)


def _tap6(a: np.ndarray, axis: int) -> np.ndarray:
    """Raw (un-normalized) 6-tap half-sample sums along ``axis``."""
    if axis == 1:
        return (a[:, :-5] - 5 * a[:, 1:-4] + 20 * a[:, 2:-3]
                + 20 * a[:, 3:-2] - 5 * a[:, 4:-1] + a[:, 5:])
    return (a[:-5] - 5 * a[1:-4] + 20 * a[2:-3]
            + 20 * a[3:-2] - 5 * a[4:-1] + a[5:])


def luma_mc(plane: np.ndarray, x: int, y: int, w: int, h: int,
            mvx: int, mvy: int) -> np.ndarray:
    """Predicted luma block of (h, w) at full-sample position (x, y)
    displaced by quarter-sample motion vector (mvx, mvy)."""
    xi, yi = x + (mvx >> 2), y + (mvy >> 2)
    xf, yf = mvx & 3, mvy & 3
    if xf == 0 and yf == 0:
        return _gather(plane, yi, xi, h, w)
    # padded full-sample region: rows yi-2 .. yi+h+2, cols xi-2 .. xi+w+2
    pad = _gather(plane, yi - 2, xi - 2, h + 5, w + 5)
    full = pad[2:2 + h, 2:2 + w]
    if yf == 0:  # horizontal half-sample row (b) + quarter averages
        b = (_tap6(pad[2:2 + h], 1) + 16) >> 5
        np.clip(b, 0, 255, out=b)
        if xf == 2:
            return b
        other = full if xf == 1 else pad[2:2 + h, 3:3 + w]
        return (other + b + 1) >> 1
    if xf == 0:  # vertical half-sample column (h) + quarter averages
        hh = (_tap6(pad[:, 2:2 + w], 0) + 16) >> 5
        np.clip(hh, 0, 255, out=hh)
        if yf == 2:
            return hh
        other = full if yf == 1 else pad[3:3 + h, 2:2 + w]
        return (other + hh + 1) >> 1
    # center/diagonal cases need the raw intermediate sums
    braw = _tap6(pad, 1)                      # (h+5, w) raw horizontal
    if xf == 2:
        # j (2,2) plus vertical quarter neighbors f (2,1) / q (2,3)
        j = (_tap6(braw[:, :], 0) + 512) >> 10
        np.clip(j, 0, 255, out=j)
        if yf == 2:
            return j
        row = 2 if yf == 1 else 3
        b = (braw[row:row + h] + 16) >> 5
        np.clip(b, 0, 255, out=b)
        return (b + j + 1) >> 1
    vraw = _tap6(pad, 0)                      # (h, w+5) raw vertical
    if yf == 2:
        # i (1,2) / k (3,2): horizontal quarter neighbors of j
        j = (_tap6(vraw, 1) + 512) >> 10
        np.clip(j, 0, 255, out=j)
        col = 2 if xf == 1 else 3
        hv = (vraw[:, col:col + w] + 16) >> 5
        np.clip(hv, 0, 255, out=hv)
        return (hv + j + 1) >> 1
    # corner quarter positions e/g/p/r: average of the nearest
    # horizontal and vertical half-samples
    row = 2 if yf == 1 else 3
    col = 2 if xf == 1 else 3
    b = (braw[row:row + h] + 16) >> 5
    np.clip(b, 0, 255, out=b)
    hv = (vraw[:, col:col + w] + 16) >> 5
    np.clip(hv, 0, 255, out=hv)
    return (b + hv + 1) >> 1


def chroma_mc(plane: np.ndarray, x: int, y: int, w: int, h: int,
              mvx: int, mvy: int) -> np.ndarray:
    """Predicted chroma block of (h, w) at full-sample chroma position
    (x, y): eighth-sample bilinear (8.4.2.2.2; mvC = mvL for 4:2:0, so
    the quarter-luma vector reads as eighth-chroma)."""
    xi, yi = x + (mvx >> 3), y + (mvy >> 3)
    xf, yf = mvx & 7, mvy & 7
    pad = _gather(plane, yi, xi, h + 1, w + 1)
    a = pad[:h, :w]
    b = pad[:h, 1:]
    c = pad[1:, :w]
    d = pad[1:, 1:]
    return ((8 - xf) * (8 - yf) * a + xf * (8 - yf) * b
            + (8 - xf) * yf * c + xf * yf * d + 32) >> 6


def weight_pred(pred: np.ndarray, w: int, o: int, log_wd: int) -> np.ndarray:
    """Explicit weighted prediction, single list (8.4.2.3.2)."""
    if log_wd >= 1:
        out = ((pred * w + (1 << (log_wd - 1))) >> log_wd) + o
    else:
        out = pred * w + o
    return np.clip(out, 0, 255)


def weight_bipred(p0: np.ndarray, p1: np.ndarray, w0: int, w1: int,
                  o0: int, o1: int, log_wd: int) -> np.ndarray:
    """Explicit weighted prediction, bi-predictive (8.4.2.3.2,
    weighted_bipred_idc == 1)."""
    out = (((p0 * w0 + p1 * w1 + (1 << log_wd)) >> (log_wd + 1))
           + ((o0 + o1 + 1) >> 1))
    return np.clip(out, 0, 255)
