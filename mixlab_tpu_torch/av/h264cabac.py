"""Pure-Python CABAC H.264 entropy decoder (zero dependencies).

The port's copy of ``mixlab_tpu/av/h264cabac.py``.

An extension of the zero-dep video tier: x264's DEFAULT entropy
coder is CABAC, so a pure tier that only speaks CAVLC covers our own
encoder's output but few third-party sources.  This module adds the
CABAC arithmetic decoding engine (spec 9.3.1.2/9.3.3.2) and the I- and
P-slice syntax decode (9.3.2/9.3.3.1): the complete intra toolset (all
nine I_4x4 modes, Intra_16x16, chroma prediction, chained mb_qp_delta,
I_PCM with mid-slice engine re-initialization) plus the full P-slice
layer — mb_skip_flag, all P mb_types and sub-8x8 shapes, unary ref_idx
with the same-MB partition context, UEG3 mvd with the |mvd| neighbor
contexts, intra-in-P (ctxIdxOffset-17 suffix) — feeding the motion
compensation, MV prediction, and derived-bS deblocking shared with the
CAVLC tier (av/h264dec.py, av/h264mc.py).

``CabacSliceDecoder`` subclasses ``_SliceDecoder``: it replaces ONLY the
entropy layer (context-modelled binary arithmetic coding instead of
Exp-Golomb/CAVLC) and feeds the same reconstruction methods, so recon
correctness is shared with the CAVLC tier's differential suites.

Validated bit-exact against libavcodec on real x264 CABAC streams
(tests/test_h264dec_cabac.py intra, tests/test_h264dec_inter.py P).
Normative tables (context init, LPS range, state transitions) come from
av/cabac_tables.py — recovered and cross-validated by
tools/extract_cabac_tables.py.  The cabac_init_idc 0 column is pinned
behaviorally by every P differential (x264 and ffmpeg-family encoders
only ever emit idc 0); columns 1/2 are symbol-identified and
cross-binary validated but have no behavioral pin — no encoder in this
image emits them, and context-shifted streams desync before a full
frame decodes on either decoder.

Scope: frame-coded I, P and B slices (B_Skip, B_Direct_16x16 and every B
mb_type and sub-partition), and the High profile's 8x8 transform
(transform_size_8x8_flag, I_8x8); the other limits are those of
av/h264dec.py.  The JAX package's copy of this docstring still says I/P
and 4x4 only.  The reference
decodes all H.264 via ffmpeg FFI
(src/rtmp/mod.rs:260-338); this tier exists so the
zero-dependency build can ingest realistic third-party RTMP video.

Spec references: ITU-T H.264 §9.3.1 (initialization), §9.3.2
(binarization), §9.3.3.1 (context derivation), §9.3.3.2 (arithmetic
decoding engine).
"""

from __future__ import annotations

import numpy as np

from mixlab_tpu_torch.av.cabac_tables import (
    INIT_I,
    INIT_PB,
    LPS_RANGE,
    TRANS_LPS,
    TRANS_MPS,
)
from mixlab_tpu_torch.av.h264cavlc import ZIGZAG, _BLK_POS
from mixlab_tpu_torch.av.h264dec import BitReader, H264DecodeError, _SliceDecoder

# normative-table blob for the C++ twin (mixlab_native.cpp h264cabac::Engine):
# INIT_I [2048] + INIT_PB[3] [6144] + LPS_RANGE [256] + TRANS_LPS [64]
# + TRANS_MPS [64]
def _pack_init(table):
    return b"".join(bytes(((m + 256) % 256, (n + 256) % 256))
                    for m, n in table)


_TABLES_PACKED = (
    _pack_init(INIT_I)
    + b"".join(_pack_init(t) for t in INIT_PB)
    + bytes(v for row in LPS_RANGE for v in row)
    + bytes(TRANS_LPS)
    + bytes(TRANS_MPS)
)
assert len(_TABLES_PACKED) == 8576

# significant/last ctx offsets per ctxBlockCat (frame coding, 4x4 cats)
_SIG_CAT_OFF = (0, 15, 29, 44, 47)
# ctxIdxInc maps for the 8x8 luma block (ctxBlockCat 5, frame coding):
# significant_coeff_flag scan-position classes and
# last_significant_coeff_flag classes (spec Table 9-43)
_SIG8_INC = (
    0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5,
    4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9, 10, 9, 8, 7,
    7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11,
    12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11, 14, 10, 12)
_LAST8_INC = ((0,) + (1,) * 15 + (2,) * 16 + (3,) * 8 + (4,) * 8
              + (5,) * 4 + (6,) * 4 + (7,) * 4 + (8,) * 3)
# coeff_abs_level_minus1 ctx offsets per ctxBlockCat
_LEV_CAT_OFF = (0, 10, 20, 30, 39)


class _CabacEngine:
    """Binary arithmetic decoding engine (spec 9.3.3.2) over the
    un-escaped RBSP bit reader.  Bits are consumed exactly one at a time,
    so ``reader.pos`` is always the precise arithmetic consumption point
    (which the I_PCM byte-realignment relies on)."""

    __slots__ = ("r", "range", "offset", "state", "mps")

    def __init__(self, r: BitReader, qp: int, init_table=INIT_I):
        # context variable init (spec 9.3.1.1) — the I column or the
        # cabac_init_idc-selected P/B column — once per slice; an I_PCM
        # reinit() restarts only the arithmetic engine
        qp = min(max(qp, 0), 51)
        state = bytearray(1024)
        mps = bytearray(1024)
        for i, (m, n) in enumerate(init_table):
            pre = ((m * qp) >> 4) + n
            pre = 1 if pre < 1 else (126 if pre > 126 else pre)
            if pre <= 63:
                state[i] = 63 - pre
                mps[i] = 0
            else:
                state[i] = pre - 64
                mps[i] = 1
        self.state = state
        self.mps = mps
        self.reinit(r)

    def reinit(self, r: BitReader):
        """Arithmetic engine (re)start (spec 9.3.1.2): at slice-data begin
        and again after each I_PCM macroblock's raw samples.  Context
        variables are NOT touched (9.3.1 invokes 9.3.1.1 only at slice
        start)."""
        self.r = r
        self.range = 510
        self.offset = r.bits(9)
        if self.offset >= 510:
            raise H264DecodeError("invalid CABAC initial codIOffset")

    def decision(self, ctx: int) -> int:
        s = self.state[ctx]
        lps = LPS_RANGE[s][(self.range >> 6) & 3]
        self.range -= lps
        if self.offset >= self.range:
            bit = 1 - self.mps[ctx]
            self.offset -= self.range
            self.range = lps
            if s == 0:
                self.mps[ctx] = 1 - self.mps[ctx]
            self.state[ctx] = TRANS_LPS[s]
        else:
            bit = self.mps[ctx]
            self.state[ctx] = TRANS_MPS[s]
        rng, off, rbit = self.range, self.offset, self.r.bit
        while rng < 256:
            rng <<= 1
            off = (off << 1) | rbit()
        self.range, self.offset = rng, off
        return bit

    def bypass(self) -> int:
        self.offset = (self.offset << 1) | self.r.bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        rng, off, rbit = self.range, self.offset, self.r.bit
        while rng < 256:
            rng <<= 1
            off = (off << 1) | rbit()
        self.range, self.offset = rng, off
        return 0


class CabacSliceDecoder(_SliceDecoder):
    """I-slice decoder with CABAC entropy; reconstruction shared with the
    scalar CAVLC tier (av/h264dec.py)."""

    def decode_slice(self, r: BitReader, nal_unit_type: int,
                     nal_ref_idc: int = 1):
        first_mb, qp, disable_idc, off_a, off_b = self._parse_slice_header(
            r, nal_unit_type, nal_ref_idc)
        # cabac_alignment_one_bit (7.3.3): pad bits up to the byte
        # boundary are all 1
        while r.pos & 7:
            if not r.bit():
                raise H264DecodeError("bad cabac_alignment_one_bit")
        is_p = self.slice_type == 0
        is_b = self.slice_type == 1
        table = (INIT_PB[self.cabac_init_idc] if (is_p or is_b)
                 else INIT_I)
        self.eng = _CabacEngine(r, qp, table)

        mbw, mbh = self.mbw, self.mbh
        # neighbor state for context derivation (9.3.3.1.1)
        self.mb_decoded = np.zeros((mbh, mbw), bool)
        self.mb_inxn = np.zeros((mbh, mbw), bool)
        self.mb_is16 = np.zeros((mbh, mbw), bool)
        self.mb_pcm = np.zeros((mbh, mbw), bool)
        self.mb_skip = np.zeros((mbh, mbw), bool)
        # B_Skip / B_Direct_16x16 MBs (mb_type ctx, 9.3.3.1.1.3)
        self._b_direct_mb = np.zeros((mbh, mbw), bool)
        self.mb_cbp = np.zeros((mbh, mbw), np.int64)  # luma | chroma << 4
        self.chroma_mode_map = np.zeros((mbh, mbw), np.int64)
        self.cbf_ldc = np.zeros((mbh, mbw), np.int8)  # luma DC (I16 only)
        self.cbf_l = np.zeros((mbh * 4, mbw * 4), np.int8)  # luma 4x4
        self.cbf_cdc = np.zeros((2, mbh, mbw), np.int8)  # chroma DC
        self.cbf_c = np.zeros((2, mbh * 2, mbw * 2), np.int8)  # chroma AC
        # |mvd| per 4x4 cell, list, and component (mvd ctx, 9.3.3.1.1.7)
        self.absmvd = np.zeros((mbh * 4, mbw * 4, 2, 2), np.int64)
        self.prev_qp_delta_nz = False

        mb_addr, n_mbs = first_mb, mbw * mbh
        while True:
            if mb_addr >= n_mbs:
                raise H264DecodeError("CABAC slice overruns the picture")
            mx, my = mb_addr % mbw, mb_addr // mbw
            if (is_p or is_b) and self._read_skip_flag(
                    mx, my, 11 if is_p else 24):
                (self._p_skip_mb if is_p else self._b_skip_mb)(mx, my)
                self.mb_skip[my, mx] = True
                if is_b:
                    self._b_direct_mb[my, mx] = True
                self.prev_qp_delta_nz = False
            elif is_p:
                self._decode_mb_cabac_p(r, mx, my)
            elif is_b:
                self._decode_mb_cabac_b(r, mx, my)
            else:
                self._decode_mb_cabac(r, mx, my)
            self.mb_decoded[my, mx] = True
            mb_addr += 1
            if self.eng.terminate():  # end_of_slice_flag
                break
        if mb_addr != n_mbs:
            raise H264DecodeError(
                f"slice ended after {mb_addr}/{n_mbs} macroblocks")
        if disable_idc != 1:
            if is_p or is_b or self.t8.any():
                self._deblock_general(off_a, off_b)
            else:
                self._deblock(off_a, off_b)

    # ---- macroblock layer ------------------------------------------------

    def _decode_mb_cabac(self, r: BitReader, mx: int, my: int):
        eng = self.eng
        # mb_type (I slices): ctxIdxOffset 3, binarization 9.3.2.5
        cond_a = mx > 0 and not self.mb_inxn[my, mx - 1]
        cond_b = my > 0 and not self.mb_inxn[my - 1, mx]
        if eng.decision(3 + cond_a + cond_b) == 0:
            self._decode_inxn_cabac(r, mx, my)
            return
        if eng.terminate():  # binIdx 1: I_PCM
            self._decode_pcm_cabac(r, mx, my)
            return
        cbp_luma = 15 if eng.decision(6) else 0
        cbp_chroma = 0
        if eng.decision(7):
            cbp_chroma = 2 if eng.decision(8) else 1
        pred_mode = (eng.decision(9) << 1) | eng.decision(10)
        self._finish_i16_cabac(mx, my, cbp_luma, cbp_chroma, pred_mode)

    def _finish_i16_cabac(self, mx: int, my: int, cbp_luma: int,
                          cbp_chroma: int, pred_mode: int):
        chroma_mode = self._read_chroma_mode(mx, my)
        qp = self._read_qp_delta(mx, my)
        self.mb_is16[my, mx] = True
        self.mb_cbp[my, mx] = cbp_luma | (cbp_chroma << 4)
        self.i4_modes[my * 4: my * 4 + 4, mx * 4: mx * 4 + 4] = 2

        # luma DC (ctxBlockCat 0) — always parsed for Intra_16x16
        dc = self._residual(0, self._cbf_inc_luma_dc(mx, my),
                            (my, mx, None), 16)
        ZD = np.zeros(16, np.int64)
        if dc is not None:
            self.cbf_ldc[my, mx] = 1
            for i, z in enumerate(ZIGZAG):
                ZD[z] = dc[i]
        ZD = ZD.reshape(4, 4)

        ZA = np.zeros((16, 4, 4), np.int64)
        if cbp_luma:
            for i, (bx, by) in enumerate(_BLK_POS):
                gx, gy = mx * 4 + bx, my * 4 + by
                coeffs = self._residual(1, self._cbf_inc_luma4(gx, gy),
                                        (gy, gx), 15)
                if coeffs is None:
                    continue
                self.cbf_l[gy, gx] = 1
                flat = np.zeros(16, np.int64)
                for k, z in enumerate(ZIGZAG[1:]):
                    flat[z] = coeffs[k]
                ZA[i] = flat.reshape(4, 4)

        CZD, CZA = self._read_chroma_cabac(mx, my, cbp_chroma)
        self._recon_i16_mb(mx, my, pred_mode, qp, ZD, ZA,
                           chroma_mode, CZD, CZA)

    def _decode_i4_mb_cabac(self, mx: int, my: int):
        eng = self.eng
        self.mb_inxn[my, mx] = True
        # (transform_size_8x8_flag would precede the modes; the PPS parse
        # rejects transform_8x8 streams with a typed error)
        gy0, gx0 = my * 4, mx * 4
        modes = []
        for bx, by in _BLK_POS:
            gx, gy = gx0 + bx, gy0 + by
            ma = int(self.i4_modes[gy, gx - 1]) if gx > 0 else -1
            mb_ = int(self.i4_modes[gy - 1, gx]) if gy > 0 else -1
            pm = 2 if (ma < 0 or mb_ < 0) else min(ma, mb_)
            if eng.decision(68):  # prev_intra4x4_pred_mode_flag
                mode = pm
            else:
                # rem_intra4x4_pred_mode: FL cMax 7, binIdx 0 = LSB
                rem = (eng.decision(69) | (eng.decision(69) << 1)
                       | (eng.decision(69) << 2))
                mode = rem if rem < pm else rem + 1
            self.i4_modes[gy, gx] = mode
            modes.append(mode)
        chroma_mode = self._read_chroma_mode(mx, my)
        cbp_luma, cbp_chroma = self._read_cbp(mx, my)
        self.mb_cbp[my, mx] = cbp_luma | (cbp_chroma << 4)
        if cbp_luma or cbp_chroma:
            qp = self._read_qp_delta(mx, my)
        else:
            qp = self.qp_prev
            self.qp_map[my, mx] = qp
            self.prev_qp_delta_nz = False

        Z = np.zeros((16, 4, 4), np.int64)
        for i, (bx, by) in enumerate(_BLK_POS):
            if not (cbp_luma >> (i >> 2)) & 1:
                continue
            gx, gy = gx0 + bx, gy0 + by
            coeffs = self._residual(2, self._cbf_inc_luma4(gx, gy),
                                    (gy, gx), 16)
            if coeffs is None:
                continue
            self.cbf_l[gy, gx] = 1
            flat = np.zeros(16, np.int64)
            for k, z in enumerate(ZIGZAG):
                flat[z] = coeffs[k]
            Z[i] = flat.reshape(4, 4)
        CZD, CZA = self._read_chroma_cabac(mx, my, cbp_chroma)
        self._recon_i4_mb(mx, my, modes, qp, Z, chroma_mode, CZD, CZA)

    def _read_t8_flag(self, mx: int, my: int) -> bool:
        """transform_size_8x8_flag (ctx 399-401): condTermFlagN is the
        neighbor MB's own flag."""
        cond_a = mx > 0 and bool(self.t8[my, mx - 1])
        cond_b = my > 0 and bool(self.t8[my - 1, mx])
        return bool(self.eng.decision(399 + cond_a + cond_b))

    def _decode_inxn_cabac(self, r: BitReader, mx: int, my: int):
        """I_NxN: 4x4 or 8x8 transform (High profile)."""
        if self.pps.transform_8x8 and self._read_t8_flag(mx, my):
            self._decode_i8_mb_cabac(mx, my)
        else:
            self._decode_i4_mb_cabac(mx, my)

    def _decode_i8_mb_cabac(self, mx: int, my: int):
        eng = self.eng
        self.mb_inxn[my, mx] = True
        self.t8[my, mx] = True
        gy0, gx0 = my * 4, mx * 4
        modes = []
        for b8 in range(4):
            gx, gy = gx0 + (b8 & 1) * 2, gy0 + (b8 >> 1) * 2
            ma = int(self.i4_modes[gy, gx - 1]) if gx > 0 else -1
            mb_ = int(self.i4_modes[gy - 1, gx]) if gy > 0 else -1
            pm = 2 if (ma < 0 or mb_ < 0) else min(ma, mb_)
            if eng.decision(68):  # prev_intra8x8_pred_mode_flag
                mode = pm
            else:
                rem = (eng.decision(69) | (eng.decision(69) << 1)
                       | (eng.decision(69) << 2))
                mode = rem if rem < pm else rem + 1
            self.i4_modes[gy: gy + 2, gx: gx + 2] = mode
            modes.append(mode)
        chroma_mode = self._read_chroma_mode(mx, my)
        cbp_luma, cbp_chroma = self._read_cbp(mx, my)
        self.mb_cbp[my, mx] = cbp_luma | (cbp_chroma << 4)
        if cbp_luma or cbp_chroma:
            qp = self._read_qp_delta(mx, my)
        else:
            qp = self.qp_prev
            self.qp_map[my, mx] = qp
            self.prev_qp_delta_nz = False
        Z8 = self._read_luma8_cabac(mx, my, cbp_luma)
        CZD, CZA = self._read_chroma_cabac(mx, my, cbp_chroma)
        self._recon_i8_mb(mx, my, modes, qp, Z8, chroma_mode, CZD, CZA)

    def _read_luma8_cabac(self, mx: int, my: int,
                          cbp_luma: int) -> np.ndarray:
        """CABAC 8x8 luma residual (ctxBlockCat 5); the per-4x4 cbf
        state of an 8x8 MB is the CBP bit of the covering 8x8 block
        (9.3.3.1.1.9 transBlockN), and nnz feeds deblocking bS."""
        from mixlab_tpu_torch.av.h264dec import ZIGZAG8

        Z8 = np.zeros((4, 8, 8), np.int64)
        gy0, gx0 = my * 4, mx * 4
        self.nnz_y[gy0: gy0 + 4, gx0: gx0 + 4] = 0
        for b8 in range(4):
            gx, gy = gx0 + (b8 & 1) * 2, gy0 + (b8 >> 1) * 2
            bit = (cbp_luma >> b8) & 1
            self.cbf_l[gy: gy + 2, gx: gx + 2] = bit
            if not bit:
                continue
            coeffs = self._residual(5, 0, None, 64)
            if coeffs is None:
                continue
            flat = np.zeros(64, np.int64)
            nz = 0
            for k, z in enumerate(ZIGZAG8):
                flat[z] = coeffs[k]
                if coeffs[k]:
                    nz += 1
            Z8[b8] = flat.reshape(8, 8)
            if nz:
                self.coded8[my * 2 + (b8 >> 1), mx * 2 + (b8 & 1)] = True
        return Z8

    # ---- P macroblock layer (spec 7.3.5, 9.3.3.1) ------------------------

    def _read_skip_flag(self, mx: int, my: int, base: int = 11) -> bool:
        """mb_skip_flag (9.3.3.1.1.1): condTermFlagN = 1 iff mbAddrN is
        available and NOT skipped; ctx base 11 for P slices, 24 for B."""
        cond_a = mx > 0 and not self.mb_skip[my, mx - 1]
        cond_b = my > 0 and not self.mb_skip[my - 1, mx]
        return bool(self.eng.decision(base + cond_a + cond_b))

    def _read_ref_idx_cabac(self, gx: int, gy: int, lx: int = 0) -> int:
        """ref_idx_lX: unary, ctx 54-59 (9.3.3.1.1.6); present only when
        the list has more than one active entry (7.3.5.1)."""
        if self.num_ref_active[lx] == 1:
            return 0
        eng = self.eng

        def nref(cx, cy):
            """Neighbor ref for the ctx: cells of earlier partitions in
            the CURRENT MB are known from the ref-read phase (refknown)
            before their MVs decode; direct-inferred cells never raise
            the context (9.3.3.1.1.6)."""
            if (cx < 0 or cy < 0 or cx >= self.mbw * 4
                    or cy >= self.mbh * 4):
                return -2
            if self.direct4[cy, cx]:
                return 0
            if self.refknown[cy, cx, lx] or self.decoded4[cy, cx]:
                return int(self.refidx[cy, cx, lx])
            return -2

        inc = (nref(gx - 1, gy) > 0) + 2 * (nref(gx, gy - 1) > 0)
        if not eng.decision(54 + inc):
            idx = 0
        else:
            idx = 1
            while idx < 32 and eng.decision(58 if idx == 1 else 59):
                idx += 1
            if idx >= 32:
                raise H264DecodeError("ref_idx unary overflow")
        lst = self.lists[lx]
        n = len(lst)
        if idx >= n or lst[idx] is None:
            raise H264DecodeError(f"ref_idx {idx} outside the {n}-entry "
                                  "reference list")
        return idx

    def _read_mvd_cabac(self, gx: int, gy: int, comp: int,
                        lx: int = 0) -> int:
        """mvd_lX component: UEG3 (prefix TU ctx-coded to 9, EG3 bypass
        suffix, bypass sign), ctx 40-46 / 47-53 (9.3.3.1.1.7); the
        neighbor |mvd| context is per-list."""
        eng = self.eng
        base = 40 if comp == 0 else 47

        def amvd(cx, cy):
            if (cx < 0 or cy < 0 or cx >= self.mbw * 4
                    or cy >= self.mbh * 4 or not self.decoded4[cy, cx]):
                return 0
            return int(self.absmvd[cy, cx, lx, comp])

        e = amvd(gx - 1, gy) + amvd(gx, gy - 1)
        inc = 0 if e < 3 else (2 if e > 32 else 1)
        if not eng.decision(base + inc):
            return 0
        val, ctx = 1, 3
        while val < 9 and eng.decision(base + ctx):
            if ctx < 6:
                ctx += 1
            val += 1
        if val >= 9:  # EG3 escape suffix in bypass
            k = 3
            while eng.bypass():
                val += 1 << k
                k += 1
                if k > 24:
                    raise H264DecodeError("mvd suffix overflow")
            while k:
                k -= 1
                val += eng.bypass() << k
        return -val if eng.bypass() else val

    def _intra_in_inter_cabac(self, r: BitReader, mx: int, my: int,
                              base: int):
        """Intra mb_type suffix inside a P (base 17) or B (base 32)
        slice: element-position contexts base / base+1 / base+2 x2 /
        base+3 x2 (9.3.2.5)."""
        eng = self.eng
        self.decoded4[my * 4: my * 4 + 4, mx * 4: mx * 4 + 4] = True
        if eng.decision(base) == 0:
            self._decode_inxn_cabac(r, mx, my)
            return
        if eng.terminate():
            self._decode_pcm_cabac(r, mx, my)
            return
        cbp_luma = 15 if eng.decision(base + 1) else 0
        cbp_chroma = 0
        if eng.decision(base + 2):
            cbp_chroma = 2 if eng.decision(base + 2) else 1
        pred_mode = (eng.decision(base + 3) << 1) | eng.decision(base + 3)
        self._finish_i16_cabac(mx, my, cbp_luma, cbp_chroma, pred_mode)

    def _decode_mb_cabac_p(self, r: BitReader, mx: int, my: int):
        eng = self.eng
        # mb_type, P prefix (ctx 14-17, binarization 9.3.2.5)
        if eng.decision(14):
            self._intra_in_inter_cabac(r, mx, my, 17)
            return
        if eng.decision(15) == 0:
            mb_type = 3 * eng.decision(16)  # P_L0_16x16 / P_8x8
        else:
            mb_type = 2 - eng.decision(17)  # P_L0_L0_8x16 / _16x8
        self._mark_inter(mx, my)
        allow8 = True  # 8x8 transform needs all partitions >= 8x8
        parts = []
        if mb_type in (0, 1, 2):
            from mixlab_tpu_torch.av.h264dec import _P_PARTS

            shapes = _P_PARTS[mb_type]
            hint = {0: (None,), 1: ("16x8_top", "16x8_bot"),
                    2: ("8x16_left", "8x16_right")}[mb_type]
            refs = []
            for px, py_, w, h in shapes:
                gx, gy = mx * 4 + px // 4, my * 4 + py_ // 4
                ref = self._read_ref_idx_cabac(gx, gy)
                self.refidx[gy: gy + h // 4, gx: gx + w // 4, 0] = ref
                self.refknown[gy: gy + h // 4, gx: gx + w // 4, 0] = True
                refs.append(ref)
            for (px, py_, w, h), ref, hn in zip(shapes, refs, hint):
                gx, gy = mx * 4 + px // 4, my * 4 + py_ // 4
                dx = self._read_mvd_cabac(gx, gy, 0)
                dy = self._read_mvd_cabac(gx, gy, 1)
                px_x, px_y = self._mvp(gx, gy, w // 4, h // 4, ref, hn)
                self._set_part(mx, my, px, py_, w, h, ref,
                               px_x + dx, px_y + dy)
                self._set_absmvd(gx, gy, w // 4, h // 4, dx, dy)
                parts.append((px, py_, w, h, (ref, -1),
                              ((px_x + dx, px_y + dy), (0, 0))))
        else:  # P_8x8 (CABAC has no P_8x8ref0, Table 9-34)
            from mixlab_tpu_torch.av.h264dec import _P_SUB_PARTS

            subs = []
            for _ in range(4):
                # sub_mb_type binarization (Table 9-38, ctx 21-23)
                if eng.decision(21):
                    subs.append(0)  # P_L0_8x8
                elif not eng.decision(22):
                    subs.append(1)  # P_L0_8x4
                elif eng.decision(23):
                    subs.append(2)  # P_L0_4x8
                else:
                    subs.append(3)  # P_L0_4x4
            allow8 = all(st == 0 for st in subs)
            refs = []
            for b8 in range(4):
                bx0, by0 = (b8 % 2) * 8, (b8 // 2) * 8
                gx, gy = mx * 4 + bx0 // 4, my * 4 + by0 // 4
                ref = self._read_ref_idx_cabac(gx, gy)
                self.refidx[gy: gy + 2, gx: gx + 2, 0] = ref
                self.refknown[gy: gy + 2, gx: gx + 2, 0] = True
                refs.append(ref)
            for b8 in range(4):
                bx0, by0 = (b8 % 2) * 8, (b8 // 2) * 8
                ref = refs[b8]
                for sx, sy, w, h in _P_SUB_PARTS[subs[b8]]:
                    px, py_ = bx0 + sx, by0 + sy
                    gx, gy = mx * 4 + px // 4, my * 4 + py_ // 4
                    dx = self._read_mvd_cabac(gx, gy, 0)
                    dy = self._read_mvd_cabac(gx, gy, 1)
                    px_x, px_y = self._mvp(gx, gy, w // 4, h // 4, ref, None)
                    self._set_part(mx, my, px, py_, w, h, ref,
                                   px_x + dx, px_y + dy)
                    self._set_absmvd(gx, gy, w // 4, h // 4, dx, dy)
                    parts.append((px, py_, w, h, (ref, -1),
                                  ((px_x + dx, px_y + dy), (0, 0))))
        pred_y, pred_u, pred_v = self._inter_pred_mb(mx, my, parts)
        self._finish_inter_residual_cabac(mx, my, pred_y, pred_u, pred_v,
                                          allow8)

    def _finish_inter_residual_cabac(self, mx, my, pred_y, pred_u, pred_v,
                                     allow8=False):
        """Shared P/B CABAC inter-MB residual + reconstruction tail;
        transform_size_8x8_flag sits between coded_block_pattern and
        mb_qp_delta (7.3.5)."""
        cbp_luma, cbp_chroma = self._read_cbp(mx, my)
        self.mb_cbp[my, mx] = cbp_luma | (cbp_chroma << 4)
        t8 = False
        if cbp_luma and allow8 and self.pps.transform_8x8:
            t8 = self._read_t8_flag(mx, my)
            self.t8[my, mx] = t8
        if cbp_luma or cbp_chroma:
            qp = self._read_qp_delta(mx, my)
        else:
            qp = self.qp_prev
            self.qp_map[my, mx] = qp
            self.prev_qp_delta_nz = False
        if t8:
            Z8 = self._read_luma8_cabac(mx, my, cbp_luma)
            CZD, CZA = self._read_chroma_cabac(mx, my, cbp_chroma,
                                               cur_intra=False)
            self._recon_inter_mb8(mx, my, qp, Z8, CZD, CZA,
                                  pred_y, pred_u, pred_v)
            return

        gy0, gx0 = my * 4, mx * 4
        Z = np.zeros((16, 4, 4), np.int64)
        for i, (bx, by) in enumerate(_BLK_POS):
            if not (cbp_luma >> (i >> 2)) & 1:
                continue
            gx, gy = gx0 + bx, gy0 + by
            coeffs = self._residual(
                2, self._cbf_inc_luma4(gx, gy, cur_intra=False), (gy, gx), 16)
            if coeffs is None:
                continue
            self.cbf_l[gy, gx] = 1
            self.nnz_y[gy, gx] = sum(1 for c in coeffs if c)  # deblock bS
            flat = np.zeros(16, np.int64)
            for k, z in enumerate(ZIGZAG):
                flat[z] = coeffs[k]
            Z[i] = flat.reshape(4, 4)
        CZD, CZA = self._read_chroma_cabac(mx, my, cbp_chroma,
                                           cur_intra=False)
        self._recon_inter_mb(mx, my, qp, Z, CZD, CZA,
                             pred_y, pred_u, pred_v)

    # ---- B macroblock layer (9.3.2.5 / 9.3.3.1) --------------------------

    def _read_b_mb_type(self, mx: int, my: int) -> int:
        """mb_type for B slices (Table 9-37 binarization, ctx 27-32):
        returns 0..22, or 23 as the marker that the intra suffix
        follows."""
        eng = self.eng
        cond_a = (mx > 0 and self.mb_decoded[my, mx - 1]
                  and not self._b_direct_mb[my, mx - 1])
        cond_b = (my > 0 and self.mb_decoded[my - 1, mx]
                  and not self._b_direct_mb[my - 1, mx])
        if not eng.decision(27 + cond_a + cond_b):
            return 0  # B_Direct_16x16
        if not eng.decision(30):
            return 1 + eng.decision(32)  # B_L0_16x16 / B_L1_16x16
        bits = (eng.decision(31) << 3) | (eng.decision(32) << 2) \
            | (eng.decision(32) << 1) | eng.decision(32)
        if bits < 8:
            return bits + 3
        if bits == 13:
            return 23  # intra suffix marker
        if bits == 14:
            return 11
        if bits == 15:
            return 22  # B_8x8
        bits = (bits << 1) | eng.decision(32)
        return bits - 4

    def _read_b_sub_type(self, r: BitReader) -> int:
        """sub_mb_type for B slices (Table 9-38, ctx 36-39)."""
        eng = self.eng
        if not eng.decision(36):
            return 0  # B_Direct_8x8
        if not eng.decision(37):
            return 1 + eng.decision(39)
        t = 3
        if eng.decision(38):
            if eng.decision(39):
                return 11 + eng.decision(39)
            t += 4
        t += 2 * eng.decision(39)
        t += eng.decision(39)
        return t

    def _decode_mb_cabac_b(self, r: BitReader, mx: int, my: int):
        mb_type = self._read_b_mb_type(mx, my)
        if mb_type == 0:
            self._b_direct_mb[my, mx] = True
        if mb_type == 23:  # intra MB in a B slice (suffix base 32)
            self._intra_in_inter_cabac(r, mx, my, 32)
            return
        self._mark_inter(mx, my)

        def read_ref(gx, gy, w, h, lx):
            ref = self._read_ref_idx_cabac(gx, gy, lx)
            self.refidx[gy: gy + h // 4, gx: gx + w // 4, lx] = ref
            self.refknown[gy: gy + h // 4, gx: gx + w // 4, lx] = True
            return ref

        def read_mvd(gx, gy, comp, lx):
            return self._read_mvd_cabac(gx, gy, comp, lx)

        parts, allow8 = self._parse_b_motion(r, mx, my, mb_type,
                                             read_ref, read_mvd)
        pred_y, pred_u, pred_v = self._inter_pred_mb(mx, my, parts)
        self._finish_inter_residual_cabac(mx, my, pred_y, pred_u, pred_v,
                                          allow8)

    def _set_absmvd(self, gx: int, gy: int, w4: int, h4: int,
                    dx: int, dy: int, lx: int = 0):
        self.absmvd[gy: gy + h4, gx: gx + w4, lx, 0] = abs(dx)
        self.absmvd[gy: gy + h4, gx: gx + w4, lx, 1] = abs(dy)

    def _note_absmvd(self, gx, gy, w4, h4, dx, dy, lx):
        self._set_absmvd(gx, gy, w4, h4, dx, dy, lx)

    def _decode_pcm_cabac(self, r: BitReader, mx: int, my: int):
        """I_PCM: raw samples start at the next byte boundary after the
        exact arithmetic consumption point (pcm_alignment_zero_bit), and
        the engine re-initializes afterwards (spec 9.3.1.2)."""
        r.byte_align()
        self._store_pcm(r, mx, my)
        self.mb_pcm[my, mx] = True
        self.mb_cbp[my, mx] = 15 | (2 << 4)  # inferred (7.4.5)
        self.cbf_ldc[my, mx] = 1
        self.cbf_l[my * 4: my * 4 + 4, mx * 4: mx * 4 + 4] = 1
        self.cbf_cdc[:, my, mx] = 1
        self.cbf_c[:, my * 2: my * 2 + 2, mx * 2: mx * 2 + 2] = 1
        self.prev_qp_delta_nz = False
        self.eng.reinit(r)

    # ---- syntax elements ---------------------------------------------------

    def _read_chroma_mode(self, mx: int, my: int) -> int:
        eng = self.eng
        cond_a = (mx > 0 and not self.mb_pcm[my, mx - 1]
                  and self.chroma_mode_map[my, mx - 1] != 0)
        cond_b = (my > 0 and not self.mb_pcm[my - 1, mx]
                  and self.chroma_mode_map[my - 1, mx] != 0)
        mode = 0
        if eng.decision(64 + cond_a + cond_b):
            mode = 1
            while mode < 3 and eng.decision(67):
                mode += 1
        self.chroma_mode_map[my, mx] = mode
        return mode

    def _read_qp_delta(self, mx: int, my: int) -> int:
        eng = self.eng
        k = 0
        if eng.decision(60 + (1 if self.prev_qp_delta_nz else 0)):
            k = 1
            if eng.decision(62):
                k = 2
                while k < 88 and eng.decision(63):
                    k += 1
                if k >= 88:
                    raise H264DecodeError("mb_qp_delta unary overflow")
        delta = (k + 1) // 2 if k & 1 else -(k // 2)
        self.prev_qp_delta_nz = delta != 0
        qp = (self.qp_prev + delta + 52) % 52
        self.qp_prev = qp
        self.qp_map[my, mx] = qp
        return qp

    def _read_cbp(self, mx: int, my: int):
        """coded_block_pattern: FL(15) luma prefix (binIdx = 8x8 block
        index) + TU(2) chroma suffix (9.3.2.6, ctx 9.3.3.1.1.4)."""
        eng = self.eng
        cbp_luma = 0
        for b in range(4):
            # left 8x8 neighbor of block b
            if b & 1:
                cond_a = (cbp_luma >> (b - 1)) & 1 == 0
            elif mx > 0:
                n_cbp, n_pcm = self.mb_cbp[my, mx - 1], self.mb_pcm[my, mx - 1]
                cond_a = not n_pcm and ((int(n_cbp) >> (b + 1)) & 1) == 0
            else:
                cond_a = False
            # top 8x8 neighbor of block b
            if b & 2:
                cond_b = (cbp_luma >> (b - 2)) & 1 == 0
            elif my > 0:
                n_cbp, n_pcm = self.mb_cbp[my - 1, mx], self.mb_pcm[my - 1, mx]
                cond_b = not n_pcm and ((int(n_cbp) >> (b + 2)) & 1) == 0
            else:
                cond_b = False
            if eng.decision(73 + cond_a + 2 * cond_b):
                cbp_luma |= 1 << b
        cbp_chroma = 0
        cond_a = mx > 0 and (self.mb_pcm[my, mx - 1]
                             or (int(self.mb_cbp[my, mx - 1]) >> 4) != 0)
        cond_b = my > 0 and (self.mb_pcm[my - 1, mx]
                             or (int(self.mb_cbp[my - 1, mx]) >> 4) != 0)
        if eng.decision(77 + cond_a + 2 * cond_b):
            cond_a = mx > 0 and (self.mb_pcm[my, mx - 1]
                                 or (int(self.mb_cbp[my, mx - 1]) >> 4) == 2)
            cond_b = my > 0 and (self.mb_pcm[my - 1, mx]
                                 or (int(self.mb_cbp[my - 1, mx]) >> 4) == 2)
            cbp_chroma = 2 if eng.decision(81 + cond_a + 2 * cond_b) else 1
        return cbp_luma, cbp_chroma

    def _read_chroma_cabac(self, mx: int, my: int, cbp_chroma: int,
                           cur_intra: bool = True):
        CZD = [np.zeros((2, 2), np.int64), np.zeros((2, 2), np.int64)]
        CZA = [np.zeros((4, 4, 4), np.int64), np.zeros((4, 4, 4), np.int64)]
        if cbp_chroma:
            for comp in range(2):
                dc = self._residual(
                    3, self._cbf_inc_chroma_dc(mx, my, comp, cur_intra),
                    None, 4)
                if dc is not None:
                    self.cbf_cdc[comp, my, mx] = 1
                    CZD[comp] = np.array(
                        [[dc[0], dc[1]], [dc[2], dc[3]]], np.int64)
        if cbp_chroma == 2:
            for comp in range(2):
                for i in range(4):
                    gx, gy = mx * 2 + i % 2, my * 2 + i // 2
                    coeffs = self._residual(
                        4, self._cbf_inc_chroma_ac(gx, gy, comp, cur_intra),
                        None, 15)
                    if coeffs is None:
                        continue
                    self.cbf_c[comp, gy, gx] = 1
                    flat = np.zeros(16, np.int64)
                    for k, z in enumerate(ZIGZAG[1:]):
                        flat[z] = coeffs[k]
                    CZA[comp][i] = flat.reshape(4, 4)
        return CZD, CZA

    # ---- coded_block_flag context (9.3.3.1.1.9) ----------------------------

    def _cbf_inc_luma_dc(self, mx: int, my: int) -> int:
        def cond(nx, ny):
            if nx < 0 or ny < 0:
                return 1  # unavailable MB, intra current (9.3.3.1.1.9)
            if self.mb_pcm[ny, nx]:
                return 1
            if not self.mb_is16[ny, nx]:
                return 0  # no luma DC transform block in mbAddrN
            return int(self.cbf_ldc[ny, nx])

        return cond(mx - 1, my) + 2 * cond(mx, my - 1)

    def _cbf_inc_luma4(self, gx: int, gy: int, cur_intra: bool = True) -> int:
        def cond(nx, ny):
            if nx < 0 or ny < 0:
                return 1 if cur_intra else 0  # 9.3.3.1.1.9
            if self.mb_pcm[ny >> 2, nx >> 2]:
                return 1
            return int(self.cbf_l[ny, nx])

        return cond(gx - 1, gy) + 2 * cond(gx, gy - 1)

    def _cbf_inc_chroma_dc(self, mx: int, my: int, comp: int,
                           cur_intra: bool = True) -> int:
        def cond(nx, ny):
            if nx < 0 or ny < 0:
                return 1 if cur_intra else 0
            if self.mb_pcm[ny, nx]:
                return 1
            return int(self.cbf_cdc[comp, ny, nx])

        return cond(mx - 1, my) + 2 * cond(mx, my - 1)

    def _cbf_inc_chroma_ac(self, gx: int, gy: int, comp: int,
                           cur_intra: bool = True) -> int:
        def cond(nx, ny):
            if nx < 0 or ny < 0:
                return 1 if cur_intra else 0
            if self.mb_pcm[ny >> 1, nx >> 1]:
                return 1
            return int(self.cbf_c[comp, ny, nx])

        return cond(gx - 1, gy) + 2 * cond(gx, gy - 1)

    # ---- residual block (9.3.2.3 / 9.3.3.1.3) -------------------------------

    def _residual(self, cat: int, cbf_inc: int, _blk, n_coeff: int):
        """One transform block: coded_block_flag, significance map, then
        levels+signs in reverse scan order.  Returns coefficient values in
        scan order, or None when coded_block_flag is 0.  ctxBlockCat 5
        (8x8 luma) has NO coded_block_flag (presence comes from the CBP
        bit) and uses the Table 9-43 scan-position context classes."""
        eng = self.eng
        if cat == 5:
            sig_base, last_base = 402, 417
        else:
            if not eng.decision(85 + 4 * cat + cbf_inc):
                return None
            sig_base = 105 + _SIG_CAT_OFF[cat]
            last_base = 166 + _SIG_CAT_OFF[cat]
        sig = [False] * n_coeff
        found_last = False
        for i in range(n_coeff - 1):
            si = _SIG8_INC[i] if cat == 5 else i
            if eng.decision(sig_base + si):
                sig[i] = True
                li = _LAST8_INC[i] if cat == 5 else i
                if eng.decision(last_base + li):
                    found_last = True
                    break
        if not found_last:
            sig[n_coeff - 1] = True
        coeffs = [0] * n_coeff
        lev_base = 426 if cat == 5 else 227 + _LEV_CAT_OFF[cat]
        num_eq1 = num_gt1 = 0
        for pos in range(n_coeff - 1, -1, -1):
            if not sig[pos]:
                continue
            ctx0 = 0 if num_gt1 else min(4, 1 + num_eq1)
            if eng.decision(lev_base + ctx0) == 0:
                level = 1
            else:
                ctx_rest = lev_base + 5 + min(4, num_gt1)
                k = 1
                while k < 14 and eng.decision(ctx_rest):
                    k += 1
                if k < 14:
                    level = k + 1
                else:
                    # UEG0 suffix (bypass): exp-Golomb order 0
                    e = 0
                    while eng.bypass():
                        e += 1
                        if e > 30:
                            raise H264DecodeError("CABAC level overflow")
                    val = 0
                    for _ in range(e):
                        val = (val << 1) | eng.bypass()
                    level = 15 + (1 << e) - 1 + val
            if level == 1:
                num_eq1 += 1
            else:
                num_gt1 += 1
            coeffs[pos] = -level if eng.bypass() else level
        return coeffs


# ---------------------------------------------------------------------------
# native C++ twin (mixlab_native.cpp h264_decode_islice_cabac)
# ---------------------------------------------------------------------------

_NATIVE_CABAC_ERRORS = {
    -20: "invalid CABAC initial codIOffset",
    -21: "CABAC level overflow",
    -22: "CABAC slice overruns the picture",
    -24: "mb_qp_delta unary overflow",
    -25: "bad cabac_alignment_one_bit",
    -3: "truncated I_PCM",
    -7: "bad Exp-Golomb code",
    -8: "bitstream truncated",
    -11: "intra prediction without required neighbors",
}


class NativeCabacSliceDecoder(_SliceDecoder):
    """CabacSliceDecoder backed by the C++ twin: same entropy + recon
    pipeline in native code, bit-exact vs the Python tier AND libavcodec
    (tests/test_h264dec_cabac.py), ~3 orders of magnitude faster — the
    tier that makes codec-less ingest of real (CABAC) RTMP video
    practical."""

    def __init__(self, sps, pps):
        self.sps = sps
        self.pps = pps
        self.dpb = None
        mbw, mbh = sps.mb_width, sps.mb_height
        self.mbw, self.mbh = mbw, mbh
        self.ry = np.zeros((mbh * 16, mbw * 16), np.uint8)
        self.ru = np.zeros((mbh * 8, mbw * 8), np.uint8)
        self.rv = np.zeros((mbh * 8, mbw * 8), np.uint8)
        self.lists = [[], []]
        self.num_ref_active = [1, 1]

    def decode_slice(self, r: BitReader, nal_unit_type: int) -> bool:
        """Returns False when the native library is unavailable (caller
        falls back to the Python tier); raises on stream errors."""
        from mixlab_tpu_torch import native

        _first_mb, qp, disable_idc, off_a, off_b = self._parse_slice_header(
            r, nal_unit_type)
        state = np.zeros(3, np.int64)
        code = native.h264_decode_islice_cabac(
            bytes(r.data) + b"\0" * 8, len(r.data), r.pos,
            self.mbw, self.mbh, qp,
            self.pps.chroma_qp_offset, self.pps.chroma_qp_offset2,
            disable_idc, off_a, off_b, _TABLES_PACKED,
            self.ry, self.ru, self.rv, state)
        if code is None:
            return False
        if code == -23:
            raise H264DecodeError(
                f"slice ended after {int(state[1])}/{self.mbw * self.mbh}"
                " macroblocks")
        if code != 0:
            raise H264DecodeError(
                _NATIVE_CABAC_ERRORS.get(code, f"native CABAC error {code}"))
        r.pos = int(state[0])
        return True
