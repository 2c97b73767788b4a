"""CAVLC Intra_16x16 H.264 encoder (pure Python/numpy).
(the port's copy of ``mixlab_tpu/av/h264cavlc.py``)

The compressed tier of the zero-dependency encoder (av/h264enc.py): every
macroblock is Intra_16x16 with DC prediction, 4x4 integer transform +
quantization, CAVLC entropy coding (ITU-T H.264 sections 8.3/8.5/8.6/9.2).
Replaces the reference's x264 FFI (codec/src/avc/encode.rs) on images with
no codec libraries; the monitor profile (all-key-frames, monitor.rs:21-22)
is exactly this encoder's shape.

Correctness anchor: the encoder maintains the DECODER's reconstruction
(spec dequant 8.5.10-8.5.12 + prediction 8.3.3), so an independent decoder
(libavcodec in tests) must reproduce our recon bit-exactly — any table or
transform error breaks that equality loudly.

The forward transform/quant stage is expressed as batched 4x4 matrix
algebra (einsum) — the same shape runs on torch int32 tensors, on any
device (``transform_quant``, the JAX package's ``transform_quant_jax``);
entropy coding stays on host like every encoder.
"""

from __future__ import annotations

import numpy as np

from mixlab_tpu_torch.av.h264enc import BitWriter, _pad_planes, _slice_header

# CAVLC VLC tables (ITU-T H.264 Tables 9-5, 9-7, 9-8, 9-9, 9-10),
# values verified against the system libavcodec's tables.
# index: [nC class][4*TotalCoeff + TrailingOnes]
COEFF_TOKEN_LEN = (
    (1, 0, 0, 0, 6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5, 10, 9, 8, 6, 11, 10, 9, 7, 13, 11, 10, 8, 13, 13, 11, 9, 13, 13, 13, 10, 14, 14, 13, 11, 14, 14, 14, 13, 15, 15, 14, 14, 15, 15, 15, 14, 16, 15, 15, 15, 16, 16, 16, 15, 16, 16, 16, 16, 16, 16, 16, 16),
    (2, 0, 0, 0, 6, 2, 0, 0, 6, 5, 3, 0, 7, 6, 6, 4, 8, 6, 6, 4, 8, 7, 7, 5, 9, 8, 8, 6, 11, 9, 9, 6, 11, 11, 11, 7, 12, 11, 11, 9, 12, 12, 12, 11, 12, 12, 12, 11, 13, 13, 13, 12, 13, 13, 13, 13, 13, 14, 13, 13, 14, 14, 14, 13, 14, 14, 14, 14),
    (4, 0, 0, 0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4, 7, 5, 5, 4, 7, 5, 5, 4, 7, 6, 6, 4, 7, 6, 6, 4, 8, 7, 7, 5, 8, 8, 7, 6, 9, 8, 8, 7, 9, 9, 8, 8, 9, 9, 9, 8, 10, 9, 9, 9, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10),
    (6, 0, 0, 0, 6, 6, 0, 0, 6, 6, 6, 0, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6),
)
COEFF_TOKEN_BITS = (
    (1, 0, 0, 0, 5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3, 7, 6, 5, 3, 7, 6, 5, 4, 15, 6, 5, 4, 11, 14, 5, 4, 8, 10, 13, 4, 15, 14, 9, 4, 11, 10, 13, 12, 15, 14, 9, 12, 11, 10, 13, 8, 15, 1, 9, 12, 11, 14, 13, 8, 7, 10, 9, 12, 4, 6, 5, 8),
    (3, 0, 0, 0, 11, 2, 0, 0, 7, 7, 3, 0, 7, 10, 9, 5, 7, 6, 5, 4, 4, 6, 5, 6, 7, 6, 5, 8, 15, 6, 5, 4, 11, 14, 13, 4, 15, 10, 9, 4, 11, 14, 13, 12, 8, 10, 9, 8, 15, 14, 13, 12, 11, 10, 9, 12, 7, 11, 6, 8, 9, 8, 10, 1, 7, 6, 5, 4),
    (15, 0, 0, 0, 15, 14, 0, 0, 11, 15, 13, 0, 8, 12, 14, 12, 15, 10, 11, 11, 11, 8, 9, 10, 9, 14, 13, 9, 8, 10, 9, 8, 15, 14, 13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14, 9, 12, 8, 10, 13, 8, 13, 7, 9, 12, 9, 12, 11, 10, 5, 8, 7, 6, 1, 4, 3, 2),
    (3, 0, 0, 0, 0, 1, 0, 0, 4, 5, 6, 0, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63),
)
# chroma DC (nC == -1): [4*TotalCoeff + TrailingOnes]
CHROMA_DC_COEFF_TOKEN_LEN = (
    (2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8, 8, 7),
)
CHROMA_DC_COEFF_TOKEN_BITS = (
    (1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2, 0),
)
# total_zeros: [TotalCoeff-1][total_zeros]
TOTAL_ZEROS_LEN = (
    (1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9),
    (3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6, 0),
    (4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6, 0, 0),
    (5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5, 0, 0, 0),
    (4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5, 0, 0, 0, 0),
    (6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6, 0, 0, 0, 0, 0),
    (6, 5, 3, 3, 3, 2, 3, 4, 3, 6, 0, 0, 0, 0, 0, 0),
    (6, 4, 5, 3, 2, 2, 3, 3, 6, 0, 0, 0, 0, 0, 0, 0),
    (6, 6, 4, 2, 2, 3, 2, 5, 0, 0, 0, 0, 0, 0, 0, 0),
    (5, 5, 3, 2, 2, 2, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (4, 4, 3, 3, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (4, 4, 2, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (3, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (2, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
)
TOTAL_ZEROS_BITS = (
    (1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1),
    (7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0, 0),
    (5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0, 0, 0),
    (3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0, 0, 0, 0),
    (5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0, 0, 0, 0, 0),
    (1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0, 0, 0, 0, 0, 0),
    (1, 1, 5, 4, 3, 3, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0),
    (1, 1, 1, 3, 3, 2, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0),
    (1, 0, 1, 3, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0),
    (1, 0, 1, 3, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (0, 1, 1, 2, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (0, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
)
# chroma DC total_zeros: [TotalCoeff-1][total_zeros]
CHROMA_DC_TOTAL_ZEROS_LEN = (
    (1, 2, 3, 3),
    (1, 2, 2, 0),
    (1, 1, 0, 0),
)
CHROMA_DC_TOTAL_ZEROS_BITS = (
    (1, 1, 1, 0),
    (1, 1, 0, 0),
    (1, 0, 0, 0),
)
# run_before: [min(zerosLeft,7)-1][run]
RUN_LEN = (
    (1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (1, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (2, 2, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (2, 2, 2, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (2, 2, 3, 3, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (2, 3, 3, 3, 3, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 0),
)
RUN_BITS = (
    (1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (3, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (3, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (3, 2, 3, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (3, 0, 1, 3, 2, 5, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0),
)

# zigzag scan of a 4x4 block (row-major flat indices)
ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)

# quant multipliers MF (position classes a/b/c) and dequant V, per qp%6
_MF_A = (13107, 11916, 10082, 9362, 8192, 7282)
_MF_B = (5243, 4660, 4194, 3647, 3355, 2893)
_MF_C = (8066, 7490, 6554, 5825, 5243, 4559)
_V_A = (10, 11, 13, 14, 16, 18)
_V_B = (16, 18, 20, 23, 25, 29)
_V_C = (13, 14, 16, 18, 20, 23)

# chroma qp mapping for qp >= 30 (Table 8-15, offset 0)
_QPC = (29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38,
        38, 39, 39, 39, 39)

_CF = np.array([[1, 1, 1, 1], [2, 1, -1, -2], [1, -1, -1, 1], [1, -2, 2, -1]],
               dtype=np.int64)
_H4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]],
               dtype=np.int64)
_H2 = np.array([[1, 1], [1, -1]], dtype=np.int64)

# luma4x4BlkIdx -> (bx, by) position of the 4x4 block within the MB
_BLK_POS = tuple(
    (2 * ((i // 4) % 2) + (i % 4) % 2, 2 * (i // 8) + (i % 4) // 2)
    for i in range(16)
)


def _mf_matrix(rem: int) -> np.ndarray:
    m = np.full((4, 4), _MF_C[rem], dtype=np.int64)
    for (i, j) in ((0, 0), (0, 2), (2, 0), (2, 2)):
        m[i, j] = _MF_A[rem]
    for (i, j) in ((1, 1), (1, 3), (3, 1), (3, 3)):
        m[i, j] = _MF_B[rem]
    return m


def _v_matrix(rem: int) -> np.ndarray:
    m = np.full((4, 4), _V_C[rem], dtype=np.int64)
    for (i, j) in ((0, 0), (0, 2), (2, 0), (2, 2)):
        m[i, j] = _V_A[rem]
    for (i, j) in ((1, 1), (1, 3), (3, 1), (3, 3)):
        m[i, j] = _V_B[rem]
    return m


def forward4x4(blocks: np.ndarray) -> np.ndarray:
    """[..., 4, 4] int residuals -> core transform W = Cf X Cf^T."""
    return np.einsum("ij,...jk,lk->...il", _CF, blocks.astype(np.int64), _CF)


def idct4x4(d: np.ndarray) -> np.ndarray:
    """Spec 8.5.12.2 inverse core transform on [..., 4, 4] int arrays;
    returns residual BEFORE the (x+32)>>6.

    Pass order matters: the spec transforms each ROW first (e/f, 8-338)
    then each column (g/h, 8-340) — the ``>>1`` floors make the order
    observable for large coefficients at low QP, and libavcodec
    (rows-first) is the conformance reference we must match bit-exactly."""
    d0, d1, d2, d3 = d[..., :, 0], d[..., :, 1], d[..., :, 2], d[..., :, 3]
    e0 = d0 + d2
    e1 = d0 - d2
    e2 = (d1 >> 1) - d3
    e3 = d1 + (d3 >> 1)
    f = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-1)
    f0, f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :], f[..., 3, :]
    g0 = f0 + f2
    g1 = f0 - f2
    g2 = (f1 >> 1) - f3
    g3 = f1 + (f3 >> 1)
    return np.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], axis=-2)


def quant4x4(W: np.ndarray, qp: int, dc_offset=False) -> np.ndarray:
    """JM-style intra quantization (encoder side only; decoder never sees
    this choice)."""
    qp6, rem = divmod(qp, 6)
    qbits = 15 + qp6
    f = (1 << qbits) // 3
    mf = _mf_matrix(rem)
    return np.sign(W) * ((np.abs(W) * mf + f) >> qbits)


def dequant4x4(Z: np.ndarray, qp: int) -> np.ndarray:
    qp6, rem = divmod(qp, 6)
    return (Z.astype(np.int64) * _v_matrix(rem)) << qp6


# ---------------------------------------------------------------------------
# CAVLC residual block writer (spec 9.2)
# ---------------------------------------------------------------------------


def write_cavlc_block(w: BitWriter, coeffs, nC: int, max_coeff: int) -> int:
    """coeffs: scan-order list (len == max_coeff). Returns TotalCoeff."""
    nz = [i for i, c in enumerate(coeffs) if c != 0]
    total = len(nz)
    t1s = 0
    t1_signs = []
    for i in reversed(nz):
        if abs(coeffs[i]) == 1 and t1s < 3:
            t1s += 1
            t1_signs.append(coeffs[i] < 0)
        else:
            break

    idx = 4 * total + t1s
    if nC == -1:
        w.u(CHROMA_DC_COEFF_TOKEN_BITS[0][idx], CHROMA_DC_COEFF_TOKEN_LEN[0][idx])
    else:
        cls = 0 if nC < 2 else 1 if nC < 4 else 2 if nC < 8 else 3
        w.u(COEFF_TOKEN_BITS[cls][idx], COEFF_TOKEN_LEN[cls][idx])
    if total == 0:
        return 0

    for neg in t1_signs:
        w.u(1 if neg else 0, 1)

    # levels, highest frequency first, excluding trailing ones
    suffix_len = 1 if (total > 10 and t1s < 3) else 0
    first = True
    for k in range(total - 1 - t1s, -1, -1):
        lev = coeffs[nz[k]]
        level_code = (abs(lev) - 1) * 2 + (0 if lev > 0 else 1)
        if first and t1s < 3:
            level_code -= 2
        first = False
        if suffix_len == 0:
            if level_code < 14:
                w.u(1, level_code + 1)
            elif level_code < 30:
                w.u(1, 15)
                w.u(level_code - 14, 4)
            else:
                w.u(1, 16)
                w.u(level_code - 30, 12)
        else:
            if (level_code >> suffix_len) < 14:
                w.u(1, (level_code >> suffix_len) + 1)
                w.u(level_code & ((1 << suffix_len) - 1), suffix_len)
            elif level_code < (15 << suffix_len):
                w.u(1, 15)
                w.u(level_code - (14 << suffix_len), suffix_len)
            else:
                w.u(1, 16)
                w.u(level_code - (15 << suffix_len), 12)
        if suffix_len == 0:
            suffix_len = 1
        if abs(lev) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1

    if total < max_coeff:
        tz = nz[-1] + 1 - total
        if max_coeff == 4:  # chroma DC
            w.u(CHROMA_DC_TOTAL_ZEROS_BITS[total - 1][tz],
                CHROMA_DC_TOTAL_ZEROS_LEN[total - 1][tz])
        else:
            w.u(TOTAL_ZEROS_BITS[total - 1][tz], TOTAL_ZEROS_LEN[total - 1][tz])
        zeros_left = tz
        for k in range(total - 1, 0, -1):
            if zeros_left <= 0:
                break
            run = nz[k] - nz[k - 1] - 1
            tab = min(zeros_left, 7) - 1
            w.u(RUN_BITS[tab][run], RUN_LEN[tab][run])
            zeros_left -= run
    return total


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------


class CavlcIntraEncoder:
    def __init__(self, qp: int = 28):
        self.qp = int(np.clip(qp, 10, 48))
        qpc_i = int(np.clip(self.qp, 0, 51))
        self.qpc = qpc_i if qpc_i < 30 else _QPC[qpc_i - 30]

    # -- prediction ----------------------------------------------------------

    @staticmethod
    def _dc_pred16(recon, y0, x0, has_top, has_left):
        if has_top and has_left:
            return (int(recon[y0 - 1, x0 : x0 + 16].sum())
                    + int(recon[y0 : y0 + 16, x0 - 1].sum()) + 16) >> 5
        if has_top:
            return (int(recon[y0 - 1, x0 : x0 + 16].sum()) + 8) >> 4
        if has_left:
            return (int(recon[y0 : y0 + 16, x0 - 1].sum()) + 8) >> 4
        return 128

    @staticmethod
    def _dc_pred_chroma(recon, y0, x0, has_top, has_left):
        """8.3.4 DC mode: per-4x4 prediction values, returned as an 8x8
        prediction block."""
        pred = np.empty((8, 8), np.int64)
        for sy in (0, 4):
            for sx in (0, 4):
                top = recon[y0 - 1, x0 + sx : x0 + sx + 4] if has_top else None
                left = recon[y0 + sy : y0 + sy + 4, x0 - 1] if has_left else None
                corner = (sx == 0 and sy == 0) or (sx == 4 and sy == 4)
                if corner and has_top and has_left:
                    v = (int(top.sum()) + int(left.sum()) + 4) >> 3
                elif sx == 4 and sy == 0:
                    if has_top:
                        v = (int(top.sum()) + 2) >> 2
                    elif has_left:
                        v = (int(left.sum()) + 2) >> 2
                    else:
                        v = 128
                elif sx == 0 and sy == 4:
                    if has_left:
                        v = (int(left.sum()) + 2) >> 2
                    elif has_top:
                        v = (int(top.sum()) + 2) >> 2
                    else:
                        v = 128
                else:  # (0,0)/(4,4) with one side missing
                    if has_top and has_left:
                        v = (int(top.sum()) + int(left.sum()) + 4) >> 3
                    elif has_top:
                        v = (int(top.sum()) + 2) >> 2
                    elif has_left:
                        v = (int(left.sum()) + 2) >> 2
                    else:
                        v = 128
                pred[sy : sy + 4, sx : sx + 4] = v
        return pred

    # -- per-component residual coding ----------------------------------------

    def _nC(self, nnz, mbw, mx, my, bx, by, grid):
        """nC from left/above neighbor 4x4 block nnz (9.2.1); grid = blocks
        per MB side (4 luma, 2 chroma)."""
        def lookup(tx, ty):
            mx2, my2 = mx, my
            if tx < 0:
                mx2 -= 1
                tx += grid
            if ty < 0:
                my2 -= 1
                ty += grid
            if mx2 < 0 or my2 < 0:
                return None
            return nnz[my2 * grid + ty, mx2 * grid + tx]

        nA = lookup(bx - 1, by)
        nB = lookup(bx, by - 1)
        if nA is not None and nB is not None:
            return (int(nA) + int(nB) + 1) >> 1
        if nA is not None:
            return int(nA)
        if nB is not None:
            return int(nB)
        return 0

    def encode_frame(self, pic) -> bytes:
        py, pu, pv, mbw, mbh = _pad_planes(pic)
        qp, qpc = self.qp, self.qpc
        w = BitWriter()
        _slice_header(w, qp_delta=qp - 26)

        recon_y = np.zeros_like(py, dtype=np.int64)
        recon_u = np.zeros_like(pu, dtype=np.int64)
        recon_v = np.zeros_like(pv, dtype=np.int64)
        nnz_y = np.zeros((mbh * 4, mbw * 4), np.int16)
        nnz_u = np.zeros((mbh * 2, mbw * 2), np.int16)
        nnz_v = np.zeros((mbh * 2, mbw * 2), np.int16)

        for my in range(mbh):
            for mx in range(mbw):
                self._encode_mb(
                    w, py, pu, pv, recon_y, recon_u, recon_v,
                    nnz_y, nnz_u, nnz_v, mx, my, mbw,
                )
        w.rbsp_trailing()
        self.last_recon = (
            np.clip(recon_y, 0, 255).astype(np.uint8),
            np.clip(recon_u, 0, 255).astype(np.uint8),
            np.clip(recon_v, 0, 255).astype(np.uint8),
        )
        return w.getvalue()

    def _encode_mb(self, w, py, pu, pv, ry, ru, rv, nnz_y, nnz_u, nnz_v,
                   mx, my, mbw):
        qp, qpc = self.qp, self.qpc
        y0, x0 = my * 16, mx * 16
        has_top, has_left = my > 0, mx > 0

        # ---- luma: predict, transform, quantize ---------------------------
        pred = self._dc_pred16(ry, y0, x0, has_top, has_left)
        resid = py[y0 : y0 + 16, x0 : x0 + 16].astype(np.int64) - pred
        blocks = np.empty((16, 4, 4), np.int64)
        for i, (bx, by) in enumerate(_BLK_POS):
            blocks[i] = resid[4 * by : 4 * by + 4, 4 * bx : 4 * bx + 4]
        W = forward4x4(blocks)

        # DC path (Hadamard over the 4x4 DC grid in raster order)
        dc_raster = np.empty((4, 4), np.int64)
        for i, (bx, by) in enumerate(_BLK_POS):
            dc_raster[by, bx] = W[i, 0, 0]
        qp6, rem = divmod(qp, 6)
        qbits = 15 + qp6
        f = (1 << qbits) // 3
        YD = (_H4 @ dc_raster @ _H4) >> 1
        ZD = np.sign(YD) * ((np.abs(YD) * _MF_A[rem] + 2 * f) >> (qbits + 1))
        # DC dequant (8.5.10)
        FD = _H4 @ ZD @ _H4
        if qp >= 12:
            dcY = (FD * _V_A[rem]) << (qp6 - 2)
        else:
            dcY = (FD * _V_A[rem] + (1 << (1 - qp6))) >> (2 - qp6)

        # AC path
        ZA = quant4x4(W, qp)
        ZA[:, 0, 0] = 0
        cbp_luma = 15 if np.any(ZA) else 0

        # ---- chroma ---------------------------------------------------------
        cy0, cx0 = my * 8, mx * 8
        chroma = []
        for plane, recon in ((pu, ru), (pv, rv)):
            cpred = self._dc_pred_chroma(recon, cy0, cx0, has_top, has_left)
            cres = plane[cy0 : cy0 + 8, cx0 : cx0 + 8].astype(np.int64) - cpred
            cblocks = np.empty((4, 4, 4), np.int64)
            for i in range(4):
                sy, sx = 4 * (i // 2), 4 * (i % 2)
                cblocks[i] = cres[sy : sy + 4, sx : sx + 4]
            CW = forward4x4(cblocks)
            cdc = np.array([[CW[0, 0, 0], CW[1, 0, 0]],
                            [CW[2, 0, 0], CW[3, 0, 0]]], np.int64)
            cqp6, crem = divmod(qpc, 6)
            cqbits = 15 + cqp6
            cf = (1 << cqbits) // 3
            CYD = _H2 @ cdc @ _H2
            CZD = np.sign(CYD) * ((np.abs(CYD) * _MF_A[crem] + 2 * cf) >> (cqbits + 1))
            CZA = quant4x4(CW, qpc)
            CZA[:, 0, 0] = 0
            chroma.append((cpred, CZD, CZA))
        any_cdc = any(np.any(c[1]) for c in chroma)
        any_cac = any(np.any(c[2]) for c in chroma)
        cbp_chroma = 2 if any_cac else (1 if any_cdc else 0)

        # ---- macroblock header ---------------------------------------------
        # Intra_16x16: mb_type = 1 + pred(DC=2) + 4*cbp_chroma + 12*(luma!=0)
        w.ue(1 + 2 + 4 * cbp_chroma + 12 * (1 if cbp_luma else 0))
        w.ue(0)  # intra_chroma_pred_mode: DC
        w.se(0)  # mb_qp_delta

        # ---- residual bitstream ---------------------------------------------
        # luma DC (zigzag of raster DC grid)
        dc_flat = ZD.reshape(-1)
        dc_scan = [int(dc_flat[z]) for z in ZIGZAG]
        nC = self._nC(nnz_y, mbw, mx, my, 0, 0, 4)
        write_cavlc_block(w, dc_scan, nC, 16)

        # nnz must be visible to later blocks of the SAME macroblock: the
        # left/above nC context is per 4x4 block, not per MB (9.2.1)
        nnz_y[my * 4 : my * 4 + 4, mx * 4 : mx * 4 + 4] = 0
        if cbp_luma:
            for i, (bx, by) in enumerate(_BLK_POS):
                flat = ZA[i].reshape(-1)
                scan = [int(flat[z]) for z in ZIGZAG[1:]]
                nC = self._nC(nnz_y, mbw, mx, my, bx, by, 4)
                tc = write_cavlc_block(w, scan, nC, 15)
                nnz_y[my * 4 + by, mx * 4 + bx] = tc

        if cbp_chroma:
            for (_, CZD, _) in chroma:
                scan = [int(CZD[0, 0]), int(CZD[0, 1]), int(CZD[1, 0]),
                        int(CZD[1, 1])]
                write_cavlc_block(w, scan, -1, 4)
        for comp, (_, _, CZA) in enumerate(chroma):
            nnz_c = nnz_u if comp == 0 else nnz_v
            nnz_c[my * 2 : my * 2 + 2, mx * 2 : mx * 2 + 2] = 0
            if cbp_chroma == 2:
                for i in range(4):
                    flat = CZA[i].reshape(-1)
                    scan = [int(flat[z]) for z in ZIGZAG[1:]]
                    nC = self._nC(nnz_c, mbw, mx, my, i % 2, i // 2, 2)
                    tc = write_cavlc_block(w, scan, nC, 15)
                    nnz_c[my * 2 + i // 2, mx * 2 + i % 2] = tc

        # ---- reconstruction (decoder-exact; spec 8.5) -----------------------
        DQ = dequant4x4(ZA if cbp_luma else np.zeros_like(ZA), qp)
        for i, (bx, by) in enumerate(_BLK_POS):
            DQ[i, 0, 0] = dcY[by, bx]
        res = (idct4x4(DQ) + 32) >> 6
        mb = np.empty((16, 16), np.int64)
        for i, (bx, by) in enumerate(_BLK_POS):
            mb[4 * by : 4 * by + 4, 4 * bx : 4 * bx + 4] = res[i]
        ry[y0 : y0 + 16, x0 : x0 + 16] = np.clip(mb + pred, 0, 255)

        for comp, (cpred, CZD, CZA) in enumerate(chroma):
            recon = ru if comp == 0 else rv
            cqp6, crem = divmod(qpc, 6)
            CF2 = _H2 @ CZD @ _H2
            # 8.5.11 in the V-table convention (LevelScale = V, the x16
            # weightScale folded out as in the AC path): >> 1, not >> 5
            dcC = ((CF2 * _V_A[crem]) << cqp6) >> 1
            CDQ = dequant4x4(CZA if cbp_chroma == 2 else np.zeros_like(CZA), qpc)
            for i in range(4):
                CDQ[i, 0, 0] = dcC[i // 2, i % 2]
            cres = (idct4x4(CDQ) + 32) >> 6
            cmb = np.empty((8, 8), np.int64)
            for i in range(4):
                sy, sx = 4 * (i // 2), 4 * (i % 2)
                cmb[sy : sy + 4, sx : sx + 4] = cres[i]
            recon[cy0 : cy0 + 8, cx0 : cx0 + 8] = np.clip(cmb + cpred, 0, 255)


def transform_quant(blocks, qp: int):
    """Batched forward 4x4 transform + intra quantization on torch int32
    tensors (the JAX package's ``transform_quant_jax``).

    blocks: [..., 4, 4] integer residuals (a tensor on any device, or an
    array, taken to the CPU); any leading batch dims.  Integer math
    throughout, so exact: matches forward4x4 + quant4x4."""
    import torch

    qp6, rem = divmod(qp, 6)
    qbits = 15 + qp6
    f = (1 << qbits) // 3
    x = torch.as_tensor(blocks).to(torch.int32)
    cf = torch.as_tensor(_CF, dtype=torch.int32, device=x.device)
    # cf @ x @ cf.T as broadcast products and sums: cuBLAS has no int32
    # matmul, and the sums of at most 4 terms of 4 are exact
    t = (cf[:, :, None] * x[..., None, :, :]).sum(-2, dtype=torch.int32)  # [..., i, k]
    W = (t[..., :, None, :] * cf[None, :, :]).sum(-1, dtype=torch.int32)  # [..., i, l]
    mf = torch.as_tensor(_mf_matrix(rem), dtype=torch.int32, device=x.device)
    return torch.sign(W) * ((torch.abs(W) * mf + f) >> qbits)
