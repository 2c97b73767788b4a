"""Vectorized CAVLC Intra_16x16 encoder — bit-exact with the scalar
reference implementation (h264cavlc.py), roughly an order of magnitude
faster, making the zero-dependency monitor tier realtime.
(the port's copy of ``mixlab_tpu/av/h264cavlc_fast.py``)

Same bitstream, different schedule:

  * **Pass 1 (wavefront)** — DC prediction needs the *reconstructed* left
    and top macroblocks, so MBs on the same anti-diagonal are independent:
    predict/transform/quantize/reconstruct a whole diagonal at a time as
    batched numpy matrix algebra (the scalar encoder walks MBs one by one).
  * **Pass 2 (flat)** — entropy coding has no wavefront: the nC contexts
    need only neighbor nonzero COUNTS, which pass 1 already produced (the
    4x4 block scan order guarantees in-MB neighbors precede their readers,
    so the final nnz grid equals what the scalar writer sees incrementally).
    All CAVLC blocks of a category are coded together: the per-coefficient
    state machines (level suffix adaptation, run_before zeros-left) become
    <=16 vectorized steps over every block at once.  Each block emits fixed
    slots of (value, nbits); slots from all categories are stably sorted
    into stream order and packed into bytes in one vectorized pass.

Equality with ``CavlcIntraEncoder.encode_frame`` is asserted byte-for-byte
in tests/test_h264cavlc_fast.py across qps, content types, and frame
geometries — the scalar encoder (itself validated against libavcodec
decode) is the oracle.
"""

from __future__ import annotations

import numpy as np

from mixlab_tpu_torch.av.h264cavlc import (
    CHROMA_DC_COEFF_TOKEN_BITS,
    CHROMA_DC_COEFF_TOKEN_LEN,
    CHROMA_DC_TOTAL_ZEROS_BITS,
    CHROMA_DC_TOTAL_ZEROS_LEN,
    COEFF_TOKEN_BITS,
    COEFF_TOKEN_LEN,
    RUN_BITS,
    RUN_LEN,
    TOTAL_ZEROS_BITS,
    TOTAL_ZEROS_LEN,
    ZIGZAG,
    _BLK_POS,
    _H2,
    _H4,
    _MF_A,
    _QPC,
    _V_A,
    _mf_matrix,
    _v_matrix,
    forward4x4,
    idct4x4,
)
from mixlab_tpu_torch.av.h264enc import _pad_planes, _slice_header

# table tensors for vectorized gathers
_CT_BITS = np.array(COEFF_TOKEN_BITS, np.int64)        # [4, 68]
_CT_LEN = np.array(COEFF_TOKEN_LEN, np.int64)
_CDC_BITS = np.array(CHROMA_DC_COEFF_TOKEN_BITS[0], np.int64)  # [20]
_CDC_LEN = np.array(CHROMA_DC_COEFF_TOKEN_LEN[0], np.int64)
_TZ_BITS = np.array(TOTAL_ZEROS_BITS, np.int64)        # [16, 16]
_TZ_LEN = np.array(TOTAL_ZEROS_LEN, np.int64)
_CTZ_BITS = np.array(CHROMA_DC_TOTAL_ZEROS_BITS, np.int64)  # [3, 4]
_CTZ_LEN = np.array(CHROMA_DC_TOTAL_ZEROS_LEN, np.int64)
_RUN_BITS_T = np.array(RUN_BITS, np.int64)             # [7, 16]
_RUN_LEN_T = np.array(RUN_LEN, np.int64)
_ZZ = np.array(ZIGZAG, np.int64)
_BLK_XY = np.array(_BLK_POS, np.int64)                 # [16, 2] (bx, by)

# slots per CAVLC block: 1 token + 3 t1 signs + 16 levels + 1 tz + 15 runs
_BLOCK_SLOTS = 36
# relative positions inside one MB's stream (gaps are fine — the stable
# sort only needs correct ordering): 0..2 header, 3 luma DC, 4..19 luma AC,
# 20/21 chroma DC (u, v), 22..25 chroma AC u, 26..29 chroma AC v
_MB_POSITIONS = 30


class _SlotRecorder:
    """BitWriter-compatible recorder collecting (value, nbits) fields."""

    def __init__(self):
        self.values = []
        self.nbits = []

    def u(self, value, n):
        if n:
            self.values.append(int(value))
            self.nbits.append(int(n))

    def ue(self, value):
        v = int(value) + 1
        self.u(v, 2 * v.bit_length() - 1)

    def se(self, value):
        self.ue(2 * value - 1 if value > 0 else -2 * value)


def _ue_fields(v: np.ndarray):
    """Vectorized Exp-Golomb ue(v) -> (value, nbits) arrays."""
    vv = v.astype(np.int64) + 1
    nb = np.int64(1)
    # bit_length via log2 is float-fragile; use frexp-free integer method
    nbits = np.zeros_like(vv)
    tmp = vv.copy()
    while np.any(tmp):
        nbits += (tmp > 0)
        tmp >>= 1
    return vv, 2 * nbits - 1


# ---------------------------------------------------------------------------
# pass 2: vectorized CAVLC for a batch of blocks
# ---------------------------------------------------------------------------


def _cavlc_batch(scans: np.ndarray, nC: np.ndarray, max_coeff: int):
    """Encode B scan-order coefficient rows [B, L] as CAVLC slot arrays.

    Returns (values [B, 36], nbits [B, 36], total [B]).  max_coeff == 4
    selects the chroma-DC tables (scalar passes nC == -1 there).  Mirrors
    write_cavlc_block (h264cavlc.py:204) step for step, with the
    per-coefficient loops turned into <=16 vectorized iterations."""
    B, L = scans.shape
    out_v = np.zeros((B, _BLOCK_SLOTS), np.int64)
    out_n = np.zeros((B, _BLOCK_SLOTS), np.int64)
    if B == 0:
        return out_v, out_n, np.zeros(0, np.int64)

    x = scans.astype(np.int64)
    nzmask = x != 0
    total = nzmask.sum(axis=1).astype(np.int64)
    # nonzero positions packed left: pos[b, k] = index of k-th nz (L pads)
    pos = np.sort(np.where(nzmask, np.arange(L)[None, :], L), axis=1)
    vals = np.take_along_axis(x, np.minimum(pos, L - 1), 1)
    a = np.abs(vals)
    rows = np.arange(B)

    def gat(arr, idx, valid):
        return np.where(valid, arr[rows, np.clip(idx, 0, L - 1)], 0)

    # ---- trailing ones (up to 3, from the highest frequency) ----
    t1_1 = (total >= 1) & (gat(a, total - 1, total >= 1) == 1)
    t1_2 = t1_1 & (total >= 2) & (gat(a, total - 2, total >= 2) == 1)
    t1_3 = t1_2 & (total >= 3) & (gat(a, total - 3, total >= 3) == 1)
    t1s = t1_1.astype(np.int64) + t1_2 + t1_3

    # ---- coeff_token ----
    idx = 4 * total + t1s
    if max_coeff == 4:
        out_v[:, 0] = _CDC_BITS[idx]
        out_n[:, 0] = _CDC_LEN[idx]
    else:
        cls = np.select([nC < 2, nC < 4, nC < 8], [0, 1, 2], 3)
        out_v[:, 0] = _CT_BITS[cls, idx]
        out_n[:, 0] = _CT_LEN[cls, idx]

    # ---- trailing-one signs (highest frequency first) ----
    for slot, (use, k) in enumerate(((t1_1, 1), (t1_2, 2), (t1_3, 3))):
        neg = gat(vals, total - k, use) < 0
        out_v[:, 1 + slot] = np.where(use, neg.astype(np.int64), 0)
        out_n[:, 1 + slot] = np.where(use, 1, 0)

    # ---- levels (suffix-length state machine, vectorized over blocks) ----
    sl = np.where((total > 10) & (t1s < 3), 1, 0).astype(np.int64)
    n_lev = total - t1s
    for j in range(L):
        active = j < n_lev
        if not active.any():
            break
        lev = gat(vals, total - 1 - t1s - j, active)
        al = np.abs(lev)
        lc = (al - 1) * 2 + (lev < 0)
        lc = np.where(active & (j == 0) & (t1s < 3), lc - 2, lc)
        lc = np.maximum(lc, 0)  # inactive lanes: keep shifts legal

        mask_s = (np.int64(1) << sl) - 1
        pre = lc >> sl
        v0 = np.where(lc < 14, 1,
                      np.where(lc < 30, (1 << 4) | (lc - 14),
                               (1 << 12) | (lc - 30)))
        n0 = np.where(lc < 14, lc + 1, np.where(lc < 30, 19, 28))
        vs = np.where(pre < 14, (np.int64(1) << sl) | (lc & mask_s),
                      np.where(lc < (np.int64(15) << sl),
                               (np.int64(1) << sl) | (lc - (np.int64(14) << sl)),
                               (1 << 12) | (lc - (np.int64(15) << sl))))
        ns = np.where(pre < 14, pre + 1 + sl,
                      np.where(lc < (np.int64(15) << sl), 15 + sl, 28))
        out_v[:, 4 + j] = np.where(active, np.where(sl == 0, v0, vs), 0)
        out_n[:, 4 + j] = np.where(active, np.where(sl == 0, n0, ns), 0)
        sl1 = np.maximum(sl, 1)
        bump = (al > (np.int64(3) << (sl1 - 1))) & (sl1 < 6)
        sl = np.where(active, sl1 + bump, sl)

    # ---- total_zeros ----
    tz = gat(pos, total - 1, total >= 1) + 1 - total
    tz = np.maximum(tz, 0)
    has_tz = (total > 0) & (total < max_coeff)
    if max_coeff == 4:
        tzv = _CTZ_BITS[np.clip(total - 1, 0, 2), np.clip(tz, 0, 3)]
        tzn = _CTZ_LEN[np.clip(total - 1, 0, 2), np.clip(tz, 0, 3)]
    else:
        tzv = _TZ_BITS[np.clip(total - 1, 0, 15), np.clip(tz, 0, 15)]
        tzn = _TZ_LEN[np.clip(total - 1, 0, 15), np.clip(tz, 0, 15)]
    out_v[:, 20] = np.where(has_tz, tzv, 0)
    out_n[:, 20] = np.where(has_tz, tzn, 0)

    # ---- run_before (zeros-left state machine) ----
    zl = np.where(has_tz, tz, 0).astype(np.int64)
    for j in range(L - 1):
        k = total - 1 - j
        active = has_tz & (k >= 1) & (zl > 0)
        if not active.any():
            break
        run = np.clip(gat(pos, k, active) - gat(pos, k - 1, active) - 1, 0, 15)
        tab = np.clip(np.minimum(zl, 7) - 1, 0, 6)
        out_v[:, 21 + j] = np.where(active, _RUN_BITS_T[tab, run], 0)
        out_n[:, 21 + j] = np.where(active, _RUN_LEN_T[tab, run], 0)
        zl = np.where(active, zl - run, zl)

    return out_v, out_n, total


# ---------------------------------------------------------------------------
# nC contexts from the final nnz grids (9.2.1)
# ---------------------------------------------------------------------------


def _nc_from_grid(nnz: np.ndarray, gy: np.ndarray, gx: np.ndarray):
    """nC for blocks at global 4x4-grid coords (gy, gx): mean of left and
    above neighbor counts with frame-edge fallbacks (h264cavlc.py:344)."""
    has_l = gx > 0
    has_a = gy > 0
    nA = np.where(has_l, nnz[gy, np.maximum(gx - 1, 0)], 0).astype(np.int64)
    nB = np.where(has_a, nnz[np.maximum(gy - 1, 0), gx], 0).astype(np.int64)
    both = has_l & has_a
    return np.where(both, (nA + nB + 1) >> 1,
                    np.where(has_l, nA, np.where(has_a, nB, 0)))


# ---------------------------------------------------------------------------
# vectorized bit packing
# ---------------------------------------------------------------------------


def _pack_bits(values: np.ndarray, nbits: np.ndarray) -> bytes:
    """MSB-first pack of variable-width fields (max 28 bits each).

    Fields are processed longest-first so each bit-position step works on a
    contiguous PREFIX of the sorted arrays — total work is O(sum(nbits)),
    not O(n_fields * max_bits)."""
    total = int(nbits.sum())
    ends = np.cumsum(nbits)
    starts = ends - nbits
    bits = np.zeros(total, np.uint8)
    by_len = np.argsort(-nbits, kind="stable")
    sv = values[by_len]
    sn = nbits[by_len]
    ss = starts[by_len]
    # how many fields still live at bit j: counts of nbits > j
    maxn = int(sn[0]) if len(sn) else 0
    hist = np.bincount(sn, minlength=maxn + 1)
    alive = len(sn) - np.cumsum(hist)  # alive[j] = count(nbits > j)
    for j in range(maxn):
        m = int(alive[j])
        if m == 0:
            break
        v = sv[:m]
        n = sn[:m]
        bits[ss[:m] + j] = (v >> (n - 1 - j)) & 1
    return np.packbits(bits).tobytes()


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------


class FastCavlcIntraEncoder:
    """Drop-in replacement for CavlcIntraEncoder (bit-identical output)."""

    def __init__(self, qp: int = 28):
        self.qp = int(np.clip(qp, 10, 48))
        qpc_i = int(np.clip(self.qp, 0, 51))
        self.qpc = qpc_i if qpc_i < 30 else _QPC[qpc_i - 30]

    # -- pass 1 ---------------------------------------------------------------
    #
    # DC superposition: DC prediction subtracts a CONSTANT from each 4x4
    # block, and forward4x4(ones) has a single nonzero at [0,0] (= 16), so
    # only the DC coefficient depends on the wavefront.  Likewise the
    # inverse transform of a DC impulse is a constant block (the >>1 lanes
    # in idct4x4 never see row/column 0 alone), so recon = idct(AC) + dc.
    # Everything heavy (forward/inverse transforms, AC quant, cbp) is
    # computed for ALL macroblocks in one batch; the wavefront loop touches
    # only boundary sums and 4x4 DC algebra.

    def _pass1(self, py, pu, pv, mbw, mbh):
        qp, qpc = self.qp, self.qpc
        qp6, rem = divmod(qp, 6)
        qbits = 15 + qp6
        f = (1 << qbits) // 3
        mf = _mf_matrix(rem)
        vmat = _v_matrix(rem)
        cqp6, crem = divmod(qpc, 6)
        cqbits = 15 + cqp6
        cfq = (1 << cqbits) // 3
        cmf = _mf_matrix(crem)
        cvmat = _v_matrix(crem)
        n_mb = mbh * mbw

        # ================= global batch (all MBs at once) =================
        # luma blocks [mbh, mbw, 16, 4, 4] in _BLK_POS order
        mb_all = py.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3)
        by4 = _BLK_XY[:, 1, None] * 4 + np.arange(4)[None, :]  # [16, 4]
        bx4 = _BLK_XY[:, 0, None] * 4 + np.arange(4)[None, :]
        blocks = mb_all[:, :, by4[:, :, None], bx4[:, None, :]].astype(np.int64)
        W = forward4x4(blocks)  # raw (pred folds into DC only)
        ZA = np.sign(W) * ((np.abs(W) * mf + f) >> qbits)
        ZA[..., 0, 0] = 0
        cbp_luma = ZA.reshape(mbh, mbw, -1).any(axis=2)
        # raw DC grid and its Hadamard (pred only shifts [0,0], exactly by
        # 256*pred before the >>1)
        dc_raster = np.zeros((mbh, mbw, 4, 4), np.int64)
        dc_raster[:, :, _BLK_XY[:, 1], _BLK_XY[:, 0]] = W[..., 0, 0]
        HDH = np.einsum("ij,abjl,lm->abim", _H4, dc_raster, _H4)
        # AC-only inverse transform (DC adds a constant per block later)
        DQ = np.where(cbp_luma[..., None, None, None], (ZA * vmat) << qp6, 0)
        idct_ac_y = idct4x4(DQ)  # [mbh, mbw, 16, 4, 4], pre (+32)>>6

        # chroma global
        cstack = np.stack([
            p.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3)
            for p in (pu, pv)
        ])  # [2, mbh, mbw, 8, 8]
        cblocks = cstack.reshape(2, mbh, mbw, 2, 4, 2, 4).transpose(
            0, 1, 2, 3, 5, 4, 6).reshape(2, mbh, mbw, 4, 4, 4).astype(np.int64)
        CW = forward4x4(cblocks)
        CZA = np.sign(CW) * ((np.abs(CW) * cmf + cfq) >> cqbits)
        CZA[..., 0, 0] = 0
        cdc = CW[..., 0, 0].reshape(2, mbh, mbw, 2, 2)
        HCH = np.einsum("ij,cabjl,lm->cabim", _H2, cdc, _H2)
        any_cac = (CZA != 0).any(axis=(0, 3, 4, 5))  # [mbh, mbw]
        CDQ = np.where(any_cac[None, :, :, None, None, None],
                       (CZA * cvmat) << cqp6, 0)
        idct_ac_c = idct4x4(CDQ)  # [2, mbh, mbw, 4, 4, 4]

        # ================= wavefront (DC algebra + recon only) ============
        recon_y = np.zeros_like(py, np.int64)
        recon_u = np.zeros_like(pu, np.int64)
        recon_v = np.zeros_like(pv, np.int64)
        recon_c = (recon_u, recon_v)
        ZD = np.zeros((mbh, mbw, 4, 4), np.int64)
        CZD = np.zeros((2, mbh, mbw, 2, 2), np.int64)
        cbp_chroma = np.zeros((mbh, mbw), np.int64)

        ar16 = np.arange(16)
        ar8 = np.arange(8)
        blk_by = _BLK_XY[:, 1]
        blk_bx = _BLK_XY[:, 0]

        for d in range(mbw + mbh - 1):
            mys = np.arange(max(0, d - mbw + 1), min(mbh, d + 1))
            mxs = d - mys
            K = len(mys)
            y0 = mys * 16
            x0 = mxs * 16
            has_t = mys > 0
            has_l = mxs > 0

            # ---- luma DC prediction (8.3.3 DC mode) ----
            ts = recon_y[np.maximum(y0 - 1, 0)[:, None],
                         x0[:, None] + ar16[None, :]].sum(axis=1)
            ls = recon_y[y0[:, None] + ar16[None, :],
                         np.maximum(x0 - 1, 0)[:, None]].sum(axis=1)
            pred = np.select(
                [has_t & has_l, has_t, has_l],
                [(ts + ls + 16) >> 5, (ts + 8) >> 4, (ls + 8) >> 4], 128)

            # ---- DC path: YD = (H (dc_raw - 16 pred E00) H) >> 1 ----
            YD = HDH[mys, mxs].copy()
            YD[:, 0, 0] -= 256 * pred
            YD >>= 1
            ZDk = np.sign(YD) * ((np.abs(YD) * _MF_A[rem] + 2 * f) >> (qbits + 1))
            ZD[mys, mxs] = ZDk
            FD = np.einsum("ij,kjl,lm->kim", _H4, ZDk, _H4)
            if qp >= 12:
                dcY = (FD * _V_A[rem]) << (qp6 - 2)
            else:
                dcY = (FD * _V_A[rem] + (1 << (1 - qp6))) >> (2 - qp6)

            # ---- recon = ((idct_ac + dc + 32) >> 6) + pred ----
            res = (idct_ac_y[mys, mxs]
                   + dcY[:, blk_by, blk_bx][:, :, None, None] + 32) >> 6
            mb_rec = np.empty((K, 16, 16), np.int64)
            mb_rec[:, by4[:, :, None], bx4[:, None, :]] = res
            recon_y[y0[:, None, None] + ar16[None, :, None],
                    x0[:, None, None] + ar16[None, None, :]] = np.clip(
                mb_rec + pred[:, None, None], 0, 255)

            # ---- chroma DC path, both components stacked [2, K, ...] ----
            cy0 = mys * 8
            cx0 = mxs * 8
            t4 = np.stack([
                r[np.maximum(cy0 - 1, 0)[:, None], cx0[:, None] + ar8[None, :]]
                for r in recon_c
            ]).reshape(2, K, 2, 4).sum(axis=3)  # [2, K, 2] left/right halves
            l4 = np.stack([
                r[cy0[:, None] + ar8[None, :], np.maximum(cx0 - 1, 0)[:, None]]
                for r in recon_c
            ]).reshape(2, K, 2, 4).sum(axis=3)  # [2, K, 2] top/bottom halves
            # quadrants in raster order (sy, sx): (0,0) (0,1) (1,0) (1,1)
            tq = t4[:, :, [0, 1, 0, 1]]
            lq = l4[:, :, [0, 0, 1, 1]]
            c_both = (tq + lq + 4) >> 3
            c_top = (tq + 2) >> 2
            c_left = (lq + 2) >> 2
            bt = has_t[None, :, None]
            bl = has_l[None, :, None]
            # corner quadrants (0,0)/(1,1) use both when available; the
            # fallback priority is top-first except quadrant (1,0)=idx 2
            is_corner = np.array([True, False, False, True])[None, None, :]
            top_first = np.array([True, True, False, True])[None, None, :]
            p1 = np.where(top_first, c_top, c_left)
            p1_ok = np.where(top_first, bt, bl)
            p2 = np.where(top_first, c_left, c_top)
            p2_ok = np.where(top_first, bl, bt)
            P = np.where(is_corner & bt & bl, c_both,
                         np.where(p1_ok, p1, np.where(p2_ok, p2, 128)))
            P = P.reshape(2, K, 2, 2)  # [2, K, sy, sx]

            # H2 (cdc_raw - 16 P) H2 = HCH_raw - 16 * H2 P H2 (exact)
            p00, p01 = P[..., 0, 0], P[..., 0, 1]
            p10, p11 = P[..., 1, 0], P[..., 1, 1]
            HPH = np.empty((2, K, 2, 2), np.int64)
            HPH[..., 0, 0] = p00 + p01 + p10 + p11
            HPH[..., 0, 1] = p00 - p01 + p10 - p11
            HPH[..., 1, 0] = p00 + p01 - p10 - p11
            HPH[..., 1, 1] = p00 - p01 - p10 + p11
            CYD = HCH[:, mys, mxs] - 16 * HPH
            CZDk = np.sign(CYD) * (
                (np.abs(CYD) * _MF_A[crem] + 2 * cfq) >> (cqbits + 1))
            CZD[:, mys, mxs] = CZDk

            any_cdc = (CZDk != 0).any(axis=(0, 2, 3))
            cbp_c = np.where(any_cac[mys, mxs], 2, np.where(any_cdc, 1, 0))
            cbp_chroma[mys, mxs] = cbp_c

            z00, z01 = CZDk[..., 0, 0], CZDk[..., 0, 1]
            z10, z11 = CZDk[..., 1, 0], CZDk[..., 1, 1]
            CF2 = np.empty((2, K, 2, 2), np.int64)
            CF2[..., 0, 0] = z00 + z01 + z10 + z11
            CF2[..., 0, 1] = z00 - z01 + z10 - z11
            CF2[..., 1, 0] = z00 + z01 - z10 - z11
            CF2[..., 1, 1] = z00 - z01 - z10 + z11
            dcC = ((CF2 * _V_A[crem]) << cqp6) >> 1
            cres2 = (idct_ac_c[:, mys, mxs]
                     + dcC.reshape(2, K, 4)[..., None, None] + 32) >> 6
            cmb_rec = cres2.reshape(2, K, 2, 2, 4, 4).transpose(
                0, 1, 2, 4, 3, 5).reshape(2, K, 8, 8)
            pq = np.repeat(np.repeat(P, 4, axis=2), 4, axis=3)
            out = np.clip(cmb_rec + pq, 0, 255)
            for comp in range(2):
                recon_c[comp][cy0[:, None, None] + ar8[None, :, None],
                              cx0[:, None, None] + ar8[None, None, :]] = (
                    out[comp])

        return (recon_y, recon_u, recon_v,
                ZD, ZA, CZD, CZA, cbp_luma, cbp_chroma)

    # -- pass 2 + assembly ------------------------------------------------------

    def encode_frame(self, pic) -> bytes:
        py, pu, pv, mbw, mbh = _pad_planes(pic)
        (recon_y, recon_u, recon_v, ZD, ZA, CZD, CZA,
         cbp_luma, cbp_chroma) = self._pass1(py, pu, pv, mbw, mbh)
        self.last_recon = (
            np.clip(recon_y, 0, 255).astype(np.uint8),
            np.clip(recon_u, 0, 255).astype(np.uint8),
            np.clip(recon_v, 0, 255).astype(np.uint8),
        )
        n_mb = mbh * mbw
        mb_idx = np.arange(n_mb).reshape(mbh, mbw)
        mys, mxs = np.divmod(np.arange(n_mb), mbw)

        # final nnz grids (equal to what the scalar writer builds up)
        nnz_y = np.zeros((mbh * 4, mbw * 4), np.int64)
        luma_counts = (ZA.reshape(mbh, mbw, 16, 16)[..., _ZZ[1:]] != 0
                       ).sum(axis=3)  # [mbh, mbw, 16] per _BLK_POS index
        luma_counts = np.where(cbp_luma[..., None], luma_counts, 0)
        for i, (bx, by) in enumerate(_BLK_POS):
            nnz_y[by::4, bx::4] = luma_counts[:, :, i].reshape(mbh, mbw)
        nnz_c = np.zeros((2, mbh * 2, mbw * 2), np.int64)
        for comp in range(2):
            cc = (CZA[comp].reshape(mbh, mbw, 4, 16)[..., _ZZ[1:]] != 0
                  ).sum(axis=3)  # [mbh, mbw, 4] blocks in raster (i%2, i//2)
            cc = np.where((cbp_chroma == 2)[..., None], cc, 0)
            for i in range(4):
                nnz_c[comp, (i // 2)::2, (i % 2)::2] = cc[:, :, i]

        keys, values, nbits = [], [], []

        def emit(key, v, n):
            keys.append(key.ravel())
            values.append(v.ravel())
            nbits.append(n.ravel())

        def block_key(mb_flat, pos_in_mb):
            """[B] mb indices + scalar/[B] position -> [B, 36] slot keys."""
            base = (mb_flat * _MB_POSITIONS + pos_in_mb) * _BLOCK_SLOTS
            return base[:, None] + np.arange(_BLOCK_SLOTS)[None, :]

        # ---- headers ----
        mb_flat = np.arange(n_mb)
        mb_type = 1 + 2 + 4 * cbp_chroma.ravel() + 12 * cbp_luma.ravel()
        v, n = _ue_fields(mb_type)
        emit((mb_flat * _MB_POSITIONS + 0) * _BLOCK_SLOTS, v, n)
        # intra_chroma_pred_mode ue(0) = '1'; mb_qp_delta se(0) = '1'
        ones = np.ones(n_mb, np.int64)
        emit((mb_flat * _MB_POSITIONS + 1) * _BLOCK_SLOTS, ones, ones)
        emit((mb_flat * _MB_POSITIONS + 2) * _BLOCK_SLOTS, ones, ones)

        # ---- luma DC blocks (all MBs) ----
        dc_scans = ZD.reshape(n_mb, 16)[:, _ZZ]
        nc_dc = _nc_from_grid(nnz_y, mys * 4, mxs * 4)
        v, n, _ = _cavlc_batch(dc_scans, nc_dc, 16)
        emit(block_key(mb_flat, 3), v, n)

        # ---- luma AC blocks (MBs with cbp_luma), ONE batch of 16 x nsel ----
        sel = cbp_luma.ravel()
        if sel.any():
            smb = mb_flat[sel]
            smy, smx = mys[sel], mxs[sel]
            nsel = len(smb)
            scans = ZA.reshape(n_mb, 16, 16)[sel][:, :, _ZZ[1:]].reshape(
                nsel * 16, 15)
            gy = (smy[:, None] * 4 + _BLK_XY[None, :, 1]).ravel()
            gx = (smx[:, None] * 4 + _BLK_XY[None, :, 0]).ravel()
            ncs = _nc_from_grid(nnz_y, gy, gx)
            v, n, _ = _cavlc_batch(scans, ncs, 15)
            pos = (np.broadcast_to(smb[:, None], (nsel, 16)).ravel()
                   * _MB_POSITIONS
                   + 4 + np.tile(np.arange(16), nsel)) * _BLOCK_SLOTS
            emit(pos[:, None] + np.arange(_BLOCK_SLOTS)[None, :], v, n)

        # ---- chroma DC blocks (MBs with cbp_chroma >= 1), u+v together ----
        selc = (cbp_chroma.ravel() >= 1)
        if selc.any():
            smb = mb_flat[selc]
            nselc = len(smb)
            scans = np.concatenate(
                [CZD[comp].reshape(n_mb, 4)[selc] for comp in range(2)])
            v, n, _ = _cavlc_batch(scans, -np.ones(2 * nselc, np.int64), 4)
            pos = (np.concatenate([smb, smb]) * _MB_POSITIONS
                   + np.repeat([20, 21], nselc)) * _BLOCK_SLOTS
            emit(pos[:, None] + np.arange(_BLOCK_SLOTS)[None, :], v, n)

        # ---- chroma AC blocks (MBs with cbp_chroma == 2), ONE batch ----
        sel2 = (cbp_chroma.ravel() == 2)
        if sel2.any():
            smb = mb_flat[sel2]
            smy, smx = mys[sel2], mxs[sel2]
            ns2 = len(smb)
            parts_s, parts_nc, parts_pos = [], [], []
            for comp in range(2):
                sc = CZA[comp].reshape(n_mb, 4, 16)[sel2][:, :, _ZZ[1:]]
                parts_s.append(sc.reshape(ns2 * 4, 15))
                gy = (smy[:, None] * 2 + (np.arange(4) // 2)[None, :]).ravel()
                gx = (smx[:, None] * 2 + (np.arange(4) % 2)[None, :]).ravel()
                parts_nc.append(_nc_from_grid(nnz_c[comp], gy, gx))
                parts_pos.append(
                    (np.broadcast_to(smb[:, None], (ns2, 4)).ravel()
                     * _MB_POSITIONS
                     + 22 + 4 * comp + np.tile(np.arange(4), ns2))
                    * _BLOCK_SLOTS)
            v, n, _ = _cavlc_batch(np.concatenate(parts_s),
                                   np.concatenate(parts_nc), 15)
            pos = np.concatenate(parts_pos)
            emit(pos[:, None] + np.arange(_BLOCK_SLOTS)[None, :], v, n)

        # ---- slice header (before everything) + rbsp trailing (after) ----
        rec = _SlotRecorder()
        _slice_header(rec, qp_delta=self.qp - 26)
        hv = np.array(rec.values, np.int64)
        hn = np.array(rec.nbits, np.int64)
        emit(np.arange(len(hv)) - (1 << 40), hv, hn)
        end_key = np.array([(n_mb + 1) * _MB_POSITIONS * _BLOCK_SLOTS + 1])
        emit(end_key, np.array([1], np.int64), np.array([1], np.int64))
        # (byte alignment zeros come from packbits padding)

        keys = np.concatenate(keys)
        values = np.concatenate(values)
        nbits = np.concatenate(nbits)
        live = nbits > 0
        keys, values, nbits = keys[live], values[live], nbits[live]
        order = np.argsort(keys, kind="stable")
        return _pack_bits(values[order], nbits[order])


# ---------------------------------------------------------------------------
# native (C++) encoder — the fastest tier
# ---------------------------------------------------------------------------


def _pack_encoder_tables() -> np.ndarray:
    """Pack the CAVLC VLC tables into the flat int16 layout consumed by the
    C++ encoder (mixlab_native.cpp h264enc:: offsets) — h264cavlc.py stays
    the single source of truth, as with the decoder's packed tables."""
    from mixlab_tpu_torch.av.h264cavlc import (
        CHROMA_DC_COEFF_TOKEN_BITS as CDCB,
        CHROMA_DC_COEFF_TOKEN_LEN as CDCL,
    )

    parts = [
        np.asarray(COEFF_TOKEN_BITS, np.int16).ravel(),       # 4*68
        np.asarray(COEFF_TOKEN_LEN, np.int16).ravel(),
        np.asarray(CDCB[0], np.int16),                        # 20
        np.asarray(CDCL[0], np.int16),
        np.asarray(TOTAL_ZEROS_BITS, np.int16).ravel(),       # 16*16
        np.asarray(TOTAL_ZEROS_LEN, np.int16).ravel(),
        np.asarray(CHROMA_DC_TOTAL_ZEROS_BITS, np.int16).ravel(),  # 3*4
        np.asarray(CHROMA_DC_TOTAL_ZEROS_LEN, np.int16).ravel(),
        np.asarray(RUN_BITS, np.int16).ravel(),               # 7*16
        np.asarray(RUN_LEN, np.int16).ravel(),
    ]
    packed = np.concatenate(parts)
    assert packed.size == 1344, packed.size  # kTablesTotal
    return np.ascontiguousarray(packed)


_ENC_TABLES: np.ndarray | None = None


class NativeCavlcIntraEncoder:
    """C++ full-frame encoder (mixlab_native.cpp h264_encode_frame),
    byte-identical to CavlcIntraEncoder / FastCavlcIntraEncoder; the per-MB
    serial walk (entropy coding + wavefront recon) runs at C speed instead
    of as numpy batch algebra.  Raises RuntimeError if the native library
    is unavailable — use make_cavlc_encoder() for automatic fallback."""

    def __init__(self, qp: int = 28):
        from mixlab_tpu_torch import native

        if not native.available():
            raise RuntimeError("native library unavailable")
        global _ENC_TABLES
        if _ENC_TABLES is None:
            _ENC_TABLES = _pack_encoder_tables()
        self.qp = int(np.clip(qp, 10, 48))
        qpc_i = int(np.clip(self.qp, 0, 51))
        self.qpc = qpc_i if qpc_i < 30 else _QPC[qpc_i - 30]

    def encode_frame(self, pic) -> bytes:
        from mixlab_tpu_torch import native
        from mixlab_tpu_torch.av.h264enc import BitWriter

        py, pu, pv, mbw, mbh = _pad_planes(pic)
        py = np.ascontiguousarray(py)
        pu = np.ascontiguousarray(pu)
        pv = np.ascontiguousarray(pv)
        w = BitWriter()
        _slice_header(w, qp_delta=self.qp - 26)
        recon_y = np.empty_like(py)
        recon_u = np.empty_like(pu)
        recon_v = np.empty_like(pv)
        rbsp = native.h264_encode_frame(
            py, pu, pv, mbw, mbh, self.qp, self.qpc,
            bytes(w.buf), w.acc, w.nbits, _ENC_TABLES,
            recon_y, recon_u, recon_v)
        if rbsp is None:  # library vanished after __init__: shouldn't happen
            raise RuntimeError("native library unavailable")
        self.last_recon = (recon_y, recon_u, recon_v)
        return rbsp


def make_cavlc_encoder(qp: int = 28):
    """Fastest available bit-exact CAVLC intra encoder: the C++ full-frame
    encoder when the native library loads, else the vectorized numpy one."""
    try:
        return NativeCavlcIntraEncoder(qp)
    except RuntimeError:
        return FastCavlcIntraEncoder(qp)
