"""Vectorized two-pass pure H.264 intra decoder.

The port's copy of ``mixlab_tpu/av/h264dec_fast.py``.

Same scope and bit-exact results as the scalar decoder (``av/h264dec.py``
— IDR I-slices, CAVLC, Intra_16x16 DC + I_PCM), restructured for
throughput the same way the fast encoder restructured the scalar one
(``av/h264cavlc_fast.py``): the serial entropy decode is table-driven
over a precomputed 16-bit-window array instead of per-bit Python, and ALL
transform math + DC prediction run batched over macroblocks.

  * Pass 1 (serial, data-dependent): one walk of the slice bitstream.
    Prefix codes resolve in one lookup against flattened 64Ki-entry
    tables (value + length indexed by the next 16 bits); Exp-Golomb and
    level prefixes use a count-leading-zeros table.  Coefficients land in
    scan order in preallocated per-MB arrays; zigzag is deferred.
  * Pass 2 (batched): zigzag scatter, dequant, and the 4x4 inverse
    transforms run as single numpy einsums over [n_mbs, ...]; DC
    prediction — the only cross-MB dependency — runs as a WAVEFRONT over
    MB anti-diagonals, with each diagonal's predictions computed from
    running bottom-row / right-column sums (DC prediction only ever
    consumes neighbor-edge SUMS, so the plane itself is assembled in one
    reshape at the end).

The scalar decoder remains the in-tree oracle; the differential test
(``tests/test_h264dec_fast.py``) asserts bit-exact plane equality across
qps, sizes, and I_PCM content.  Reference scope note as in h264dec.py:
the general case (CABAC, inter, other intra modes) is what the libavcodec
shim is for (rtmp/mod.rs:260-338 uses ffmpeg there).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from mixlab_tpu_torch.av.h264cavlc import (
    ZIGZAG,
    _BLK_POS,
    _H2,
    _H4,
    _QPC,
    _V_A,
    _v_matrix,
    idct4x4,
)
from mixlab_tpu_torch.av.h264dec import (
    _CHROMA_DC_TOKEN_DEC,
    _CHROMA_DC_TZ_DEC,
    _COEFF_TOKEN_DEC,
    _RUN_DEC,
    _TOTAL_ZEROS_DEC,
    BitReader,
    Dpb,
    H264DecodeError,
    H264Unsupported,
    _Pps,
    _SliceDecoder,
    _SpsExt,
)

# ---------------------------------------------------------------------------
# flattened decode tables
# ---------------------------------------------------------------------------


def _flatten(dec: dict) -> Tuple[bytes, bytes]:
    """(len, bits) -> value dict => two 64Ki ``bytes`` tables (value,
    length) indexed by the next 16 bits of the stream — indexing a bytes
    object returns a plain int at C speed, the hottest operation of the
    whole parse.  All values fit a byte (max CAVLC table value is 67).
    Prefix-freeness guarantees the filled ranges never overlap."""
    val = np.zeros(1 << 16, np.uint8)
    ln_arr = np.zeros(1 << 16, np.uint8)
    for (ln, bits), v in dec.items():
        lo = bits << (16 - ln)
        hi = lo + (1 << (16 - ln))
        val[lo:hi] = v
        ln_arr[lo:hi] = ln
    return val.tobytes(), ln_arr.tobytes()


_COEFF_TOKEN_FLAT = tuple(_flatten(d) for d in _COEFF_TOKEN_DEC)
_CHROMA_DC_TOKEN_FLAT = _flatten(_CHROMA_DC_TOKEN_DEC)
_TOTAL_ZEROS_FLAT = tuple(_flatten(d) for d in _TOTAL_ZEROS_DEC)
_CHROMA_DC_TZ_FLAT = tuple(_flatten(d) for d in _CHROMA_DC_TZ_DEC)
_RUN_FLAT = tuple(_flatten(d) for d in _RUN_DEC)

# one packed buffer for the C++ parse twin (mixlab_native.cpp
# h264_parse_slice): coeff_token 0-3, chroma-DC token, total_zeros 1-15,
# chroma-DC total_zeros 1-3, run_before 1-7 — layout constants kCT0..kRUN0
# in the C++ must match this order
_TABLES_PACKED = b"".join(
    v + ln
    for v, ln in (
        *_COEFF_TOKEN_FLAT,
        _CHROMA_DC_TOKEN_FLAT,
        *_TOTAL_ZEROS_FLAT[:15],
        *_CHROMA_DC_TZ_FLAT,
        *_RUN_FLAT,
    )
)
assert len(_TABLES_PACKED) == 30 * 2 * 65536

_NATIVE_ERRORS = {
    -1: "bad prefix code",
    -2: "level prefix overflow",
    -3: "truncated I_PCM",
    -7: "bad Exp-Golomb code",
    -8: "truncated slice data",
}


def _native_error(code: int, detail: int) -> H264DecodeError:
    """Map a native parse error code to the typed exception to raise.

    Codes -4/-5/-6 are fast-tier SHAPE rejections (the scalar decoder
    handles those streams) -> H264Unsupported so the caller falls back;
    the rest are stream corruption -> plain H264DecodeError."""
    if code == -4:
        return H264Unsupported(
            f"mb_type {detail} unsupported (Intra_16x16/I_PCM only)")
    if code == -5:
        return H264Unsupported(
            f"Intra_16x16 prediction mode {detail} unsupported (DC only)")
    if code == -6:
        return H264Unsupported("chroma prediction mode != DC unsupported")
    return H264DecodeError(
        _NATIVE_ERRORS.get(code, f"native parse error {code}"))

# count-leading-zeros over a 16-bit window (16 for the all-zero window)
_CLZ16_NP = np.full(1 << 16, 16, np.uint8)
_v = np.arange(1, 1 << 16)
_CLZ16_NP[_v] = (16 - np.frexp(_v.astype(np.float64))[1]).astype(np.uint8)
_CLZ16 = _CLZ16_NP.tobytes()
del _v, _CLZ16_NP


class _FastBits:
    """Bit reader over a precomputed sliding-16-bit-window LIST.

    ``win[p]`` holds bits p..p+15 (zero-padded past the end) as a plain
    Python int, so every prefix code / Exp-Golomb symbol resolves with
    one list index and one or two bytes-table lookups instead of a
    per-bit Python loop."""

    __slots__ = ("data", "win", "pos", "n", "_stop")

    def __init__(self, unescaped: bytes):
        self.data = unescaped
        bits = np.unpackbits(np.frombuffer(unescaped, np.uint8))
        n = bits.size
        ext = np.concatenate([bits.astype(np.uint32), np.zeros(16, np.uint32)])
        w = np.zeros(n + 1, np.uint32)
        for i in range(16):
            w = (w << 1) | ext[i : i + n + 1]
        self.win = w.tolist()  # list indexing beats numpy scalar extraction
        self.n = n
        self.pos = 0
        # rbsp_stop_one_bit position (cached; see h264dec.BitReader)
        nz = np.nonzero(bits)[0]
        self._stop = int(nz[-1]) if nz.size else -1

    def read(self, k: int) -> int:
        # k <= 16
        v = self.win[self.pos] >> (16 - k)
        self.pos += k
        return v

    def ue(self) -> int:
        w = self.win[self.pos]
        lz = _CLZ16[w]
        if lz > 15:
            raise H264DecodeError("bad Exp-Golomb code")
        length = 2 * lz + 1
        if length <= 16:
            self.pos += length
            return (w >> (16 - length)) - 1
        self.pos += lz + 1
        return (1 << lz) - 1 + self.read(lz)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)

    def byte_align(self):
        self.pos = (self.pos + 7) & ~7

    def more_rbsp_data(self) -> bool:
        return self.pos < self._stop


def _read_block_fast(r: _FastBits, nC: int, max_coeff: int,
                     out: np.ndarray) -> int:
    """read_cavlc_block with window reads, writing scan-order coeffs into
    ``out`` (length max_coeff, pre-zeroed).  Returns TotalCoeff.  All
    stream state is kept in locals (win list, pos int); the hot lookups
    are bytes-object indexing."""
    win = r.win
    pos = r.pos

    if nC == -1:
        val_t, len_t = _CHROMA_DC_TOKEN_FLAT
    else:
        val_t, len_t = _COEFF_TOKEN_FLAT[
            0 if nC < 2 else 1 if nC < 4 else 2 if nC < 8 else 3
        ]
    w = win[pos]
    k = len_t[w]
    if k == 0:
        raise H264DecodeError("bad prefix code")
    idx = val_t[w]
    pos += k
    total = idx >> 2
    t1s = idx & 3
    if total == 0:
        r.pos = pos
        return 0

    levels: List[int] = []
    for _ in range(t1s):
        levels.append(-1 if win[pos] >> 15 else 1)
        pos += 1

    suffix_len = 1 if (total > 10 and t1s < 3) else 0
    first = True
    for _ in range(total - t1s):
        prefix = _CLZ16[win[pos]]
        if prefix > 15:
            raise H264DecodeError("level prefix overflow")
        pos += prefix + 1
        if suffix_len == 0:
            if prefix < 14:
                level_code = prefix
            elif prefix == 14:
                level_code = 14 + (win[pos] >> 12)
                pos += 4
            else:
                level_code = 30 + (win[pos] >> 4)
                pos += 12
        else:
            if prefix < 14:
                level_code = (prefix << suffix_len) + (
                    win[pos] >> (16 - suffix_len)
                )
                pos += suffix_len
            elif prefix == 14:
                level_code = (14 << suffix_len) + (
                    win[pos] >> (16 - suffix_len)
                )
                pos += suffix_len
            else:
                level_code = (15 << suffix_len) + (win[pos] >> 4)
                pos += 12
        if first and t1s < 3:
            level_code += 2
        first = False
        lev = (level_code >> 1) + 1
        if level_code & 1:
            lev = -lev
        levels.append(lev)
        if suffix_len == 0:
            suffix_len = 1
        if (lev if lev > 0 else -lev) > (3 << (suffix_len - 1)) \
                and suffix_len < 6:
            suffix_len += 1

    if total < max_coeff:
        if max_coeff == 4:
            val_t, len_t = _CHROMA_DC_TZ_FLAT[total - 1]
        else:
            val_t, len_t = _TOTAL_ZEROS_FLAT[total - 1]
        w = win[pos]
        k = len_t[w]
        if k == 0:
            raise H264DecodeError("bad prefix code")
        tz = val_t[w]
        pos += k
    else:
        tz = 0

    p = total - 1 + tz
    if p >= max_coeff:
        raise H264DecodeError(
            f"total_zeros {tz} + total {total} exceeds block size {max_coeff}")
    zeros_left = tz
    out[p] = levels[0]
    for k in range(total - 1, 0, -1):
        if zeros_left > 0:
            val_t, len_t = _RUN_FLAT[
                (zeros_left if zeros_left < 7 else 7) - 1
            ]
            w = win[pos]
            kk = len_t[w]
            if kk == 0:
                raise H264DecodeError("bad prefix code")
            run = val_t[w]
            pos += kk
        else:
            run = 0
        p = p - run - 1
        if p < 0:
            raise H264DecodeError("corrupt run_before codes")
        out[p] = levels[total - k]
        zeros_left -= run
    r.pos = pos
    return total


# ---------------------------------------------------------------------------
# full-surface native decoder (C++ h264_decode_islice)
# ---------------------------------------------------------------------------

_NATIVE_FULL_ERRORS = dict(_NATIVE_ERRORS)


def _native_full_error(code: int, detail: int) -> H264DecodeError:
    if code == -4:
        return H264DecodeError(f"mb_type {detail} unsupported (intra only)")
    if code == -9:
        return H264DecodeError("bad intra_chroma_pred_mode")
    if code == -10:
        return H264DecodeError("bad coded_block_pattern")
    if code == -11:
        return H264DecodeError(
            f"intra prediction without required neighbors (site {detail})")
    return H264DecodeError(
        _NATIVE_FULL_ERRORS.get(code, f"native decode error {code}"))


class NativeFullSliceDecoder:
    """Drop-in for h264dec._SliceDecoder backed by the C++ FULL
    baseline-intra decoder (mixlab_native.cpp h264_decode_islice):
    I_4x4 all nine modes, Intra_16x16 V/H/DC/Plane, chroma DC/H/V/Plane,
    chained mb_qp_delta, I_PCM, spec 8.7 deblocking.  Bit-exact vs the
    scalar oracle AND libavcodec (tests/test_h264dec_intra_full.py);
    ~2 orders of magnitude faster than the scalar Python tier on
    third-party x264 streams (the RTMP ingest path)."""

    def __init__(self, sps: _SpsExt, pps: _Pps):
        self.sps = sps
        self.pps = pps
        mbw, mbh = sps.mb_width, sps.mb_height
        self.mbw, self.mbh = mbw, mbh
        self.ry = np.zeros((mbh * 16, mbw * 16), np.uint8)
        self.ru = np.zeros((mbh * 8, mbw * 8), np.uint8)
        self.rv = np.zeros((mbh * 8, mbw * 8), np.uint8)

    def decode_slice(self, r, nal_unit_type: int) -> bool:
        """Returns False when the native library is unavailable (caller
        falls back to the Python tiers); raises on stream errors."""
        from mixlab_tpu_torch import native

        if isinstance(r, (bytes, bytearray)):
            r = BitReader(bytes(r))
        sps, pps = self.sps, self.pps
        if getattr(pps, "entropy_cabac", False):
            raise H264Unsupported("CABAC slices decode via h264cabac")
        first_mb = r.ue()
        if first_mb != 0:
            raise H264DecodeError("multi-slice pictures unsupported")
        slice_type = r.ue()
        if slice_type % 5 != 2:
            raise H264DecodeError(f"non-I slice {slice_type} unsupported")
        r.ue()  # pps id
        r.bits(sps.log2_max_frame_num)
        if nal_unit_type == 5:
            r.ue()  # idr_pic_id
        if sps.poc_type == 0:
            r.bits(sps.log2_max_poc_lsb)
        if nal_unit_type == 5:
            r.bits(1)
            r.bits(1)
        qp = pps.pic_init_qp + r.se()
        disable_idc = 0
        off_a = off_b = 0
        if pps.deblocking_control:
            disable_idc = r.ue()
            if disable_idc > 2:
                raise H264DecodeError("bad disable_deblocking_filter_idc")
            if disable_idc != 1:
                off_a = 2 * r.se()
                off_b = 2 * r.se()

        state = np.zeros(3, np.int64)
        code = native.h264_decode_islice(
            bytes(r.data) + b"\0" * 8, len(r.data), r.pos,
            self.mbw, self.mbh, qp,
            pps.chroma_qp_offset, pps.chroma_qp_offset2,
            disable_idc, off_a, off_b, _TABLES_PACKED,
            self.ry, self.ru, self.rv, state)
        if code is None:
            return False
        if code != 0:
            raise _native_full_error(code, int(state[2]))
        n_total = self.mbw * self.mbh
        if int(state[1]) != n_total:
            raise H264DecodeError(
                f"slice ended after {int(state[1])}/{n_total} macroblocks")
        r.pos = int(state[0])
        return True


# ---------------------------------------------------------------------------
# native P-slice decoder (C++ h264_decode_pslice)
# ---------------------------------------------------------------------------

_NATIVE_P_ERRORS = {
    -3: "truncated I_PCM",
    -4: "bad mb_type",
    -7: "bad Exp-Golomb code",
    -8: "bitstream truncated",
    -9: "bad intra_chroma_pred_mode",
    -10: "bad coded_block_pattern",
    -11: "intra prediction without required neighbors",
    -20: "invalid CABAC initial codIOffset",
    -21: "CABAC level overflow",
    -22: "CABAC slice overruns the picture",
    -24: "mb_qp_delta unary overflow",
    -25: "bad cabac_alignment_one_bit",
    -33: "bad P sub_mb_type",
    -34: "ref_idx unary overflow",
    -35: "mvd suffix overflow",
    -36: "mb_skip_run overruns the picture",
    -41: "temporal direct: co-located reference picture not in the "
         "current list0",
}


class NativeInterSliceDecoder(_SliceDecoder):
    """P/B-slice decoder backed by the C++ twin (mixlab_native.cpp
    h264_decode_inter): the slice header parses in Python (POC, ref
    list init + modification, weights, marking — shared with the scalar
    tier), then the macroblock layer, fractional-sample MC, B direct
    prediction, and derived-bS deblocking run natively for BOTH entropy
    modes, with the per-4x4 motion exported for DPB storage (later B
    pictures' direct modes).  Bit-exact vs the Python tiers AND
    libavcodec (tests/test_h264dec_inter.py, test_h264dec_bslice.py) —
    the tier that makes codec-less ingest of real (inter-coded) RTMP
    video practical."""

    def __init__(self, sps: _SpsExt, pps: _Pps, dpb: Dpb):
        self.sps = sps
        self.pps = pps
        self.dpb = dpb
        mbw, mbh = sps.mb_width, sps.mb_height
        self.mbw, self.mbh = mbw, mbh
        self.ry = np.zeros((mbh * 16, mbw * 16), np.uint8)
        self.ru = np.zeros((mbh * 8, mbw * 8), np.uint8)
        self.rv = np.zeros((mbh * 8, mbw * 8), np.uint8)
        # header-parse defaults normally seeded by _SliceDecoder.__init__
        self.cabac_init_idc = 0
        self.adaptive_marking = False
        self.marking_ops = []
        self.frame_num = 0
        self.is_ref = True
        self.lists = [[], []]
        self.num_ref_active = [1, 1]
        self.wp = None
        self.implicit_wp = False
        self.direct_spatial = True
        self.poc = 0

    def decode_slice(self, r: BitReader, nal_unit_type: int,
                     nal_ref_idc: int = 1) -> bool:
        """Returns False when the native library is unavailable or the
        slice is not P/B (caller falls back to the Python tiers); raises
        on stream errors."""
        from mixlab_tpu_torch import native
        from mixlab_tpu_torch.av.h264cabac import _TABLES_PACKED as _CABAC_BLOB

        _first_mb, qp, disable_idc, off_a, off_b = self._parse_slice_header(
            r, nal_unit_type, nal_ref_idc)
        if self.slice_type not in (0, 1):
            return False
        is_b = self.slice_type == 1
        pics = []
        slot_of = {}
        per = []
        for lx in (0, 1):
            n = max(self.num_ref_active[lx], 1)
            slot = np.full(n, -1, np.int64)
            pid = np.full(n, -1, np.int64)
            poc = np.zeros(n, np.int64)
            lst = self.lists[lx] if (lx == 0 or is_b) else []
            for i, p in enumerate(lst):
                if p is None:
                    continue
                if id(p) not in slot_of:
                    slot_of[id(p)] = len(pics)
                    pics.append(p)
                slot[i] = slot_of[id(p)]
                pid[i] = p.pid
                poc[i] = p.poc if p.poc is not None else 0
            per.append((slot, pid, poc))
        refs_y = np.stack([p.y for p in pics])
        refs_u = np.stack([p.u for p in pics])
        refs_v = np.stack([p.v for p in pics])
        # co-located motion of RefPicList1[0] (B direct modes)
        col_mv = col_ridx = col_rpid = col_rpoc = None
        col_valid = col_intra = 0
        col_poc = 0
        if is_b:
            col = self.lists[1][0]
            col_poc = col.poc or 0
            if col.intra_only:
                col_valid = col_intra = 1
            elif col.mv is not None:
                col_valid = 1
                col_mv = np.ascontiguousarray(col.mv, np.int16)
                col_ridx = np.ascontiguousarray(col.refidx, np.int8)
                col_rpid = np.ascontiguousarray(col.refpid, np.int64)
                col_rpoc = np.ascontiguousarray(col.refpoc, np.int64)
        wp_arr = None
        if self.wp is not None:
            log_y, log_c, per_list = self.wp
            flat = [v for entries in per_list for e in entries for v in e]
            wp_arr = np.array([log_y, log_c] + flat, np.int64)
        cfg = np.array([
            self.mbw, self.mbh, qp,
            self.pps.chroma_qp_offset, self.pps.chroma_qp_offset2,
            disable_idc, off_a, off_b,
            1 if self.pps.entropy_cabac else 0, self.cabac_init_idc,
            self.slice_type, 1 if self.direct_spatial else 0,
            1 if self.implicit_wp else 0, self.poc or 0,
            self.num_ref_active[0], self.num_ref_active[1],
            len(pics), col_valid, col_intra, col_poc], np.int64)
        h4, w4 = self.mbh * 4, self.mbw * 4
        mv_out = np.zeros((h4, w4, 2, 2), np.int16)
        ridx_out = np.full((h4, w4, 2), -1, np.int8)
        rpid_out = np.full((h4, w4, 2), -1, np.int64)
        rpoc_out = np.zeros((h4, w4, 2), np.int64)
        state = np.zeros(3, np.int64)
        code = native.h264_decode_inter(
            bytes(r.data) + b"\0" * 8, len(r.data), r.pos, cfg,
            refs_y, refs_u, refs_v,
            per[0][0], per[0][1], per[0][2],
            per[1][0], per[1][1], per[1][2],
            col_mv, col_ridx, col_rpid, col_rpoc,
            wp_arr, _TABLES_PACKED, _CABAC_BLOB,
            self.ry, self.ru, self.rv,
            mv_out, ridx_out, rpid_out, rpoc_out, state)
        if code is None:
            return False
        if code == -23:
            raise H264DecodeError(
                f"slice ended after {int(state[1])}/{self.mbw * self.mbh}"
                " macroblocks")
        if code == -32:
            raise H264DecodeError(
                f"ref_idx {int(state[2])} outside the reference list")
        if code == -40:
            raise H264Unsupported(
                "B direct prediction from a reference picture decoded "
                "without exported motion")
        if code != 0:
            raise H264DecodeError(
                _NATIVE_P_ERRORS.get(code, f"native decode error {code}"))
        r.pos = int(state[0])
        # per-4x4 motion for DPB storage (B direct on later pictures)
        self.mv = mv_out
        self.refidx = ridx_out
        self.refpid = rpid_out
        self.refpoc = rpoc_out
        return True


# ---------------------------------------------------------------------------
# the two-pass slice decoder
# ---------------------------------------------------------------------------

_ZIG = np.array(ZIGZAG)
_ZIG_AC = np.array(ZIGZAG[1:])
_BX = np.array([p[0] for p in _BLK_POS])
_BY = np.array([p[1] for p in _BLK_POS])
_V6 = np.stack([_v_matrix(r) for r in range(6)])  # [6,4,4]
_VA6 = np.asarray(_V_A, np.int64)
_QPC_MAP = np.concatenate(
    [np.arange(30, dtype=np.int64), np.asarray(_QPC, np.int64)]
)


class FastSliceDecoder:
    """Drop-in for h264dec._SliceDecoder (same constructor/decode_slice
    surface, bit-exact planes)."""

    def __init__(self, sps: _SpsExt, pps: _Pps):
        self.sps = sps
        self.pps = pps
        mbw, mbh = sps.mb_width, sps.mb_height
        self.mbw, self.mbh = mbw, mbh
        self.ry = np.zeros((mbh * 16, mbw * 16), np.int64)
        self.ru = np.zeros((mbh * 8, mbw * 8), np.int64)
        self.rv = np.zeros((mbh * 8, mbw * 8), np.int64)

    def decode_slice(self, r, nal_unit_type: int):
        # accept either a raw BitReader (unescaped data inside) or bytes
        if isinstance(r, (bytes, bytearray)):
            r = BitReader(bytes(r))
        sps, pps = self.sps, self.pps
        if getattr(pps, "entropy_cabac", False):
            raise H264Unsupported("CABAC slices decode via h264cabac")

        first_mb = r.ue()
        if first_mb != 0:
            # slice-boundary intra-pred availability is scalar-tier work
            raise H264Unsupported("first_mb != 0 unsupported (fast tier)")
        slice_type = r.ue()
        if slice_type % 5 != 2:
            raise H264DecodeError(f"non-I slice {slice_type} unsupported")
        r.ue()  # pps id
        r.bits(sps.log2_max_frame_num)
        if nal_unit_type == 5:
            r.ue()  # idr_pic_id
        if sps.poc_type == 0:
            r.bits(sps.log2_max_poc_lsb)
        if nal_unit_type == 5:
            r.bits(1)
            r.bits(1)
        qp = pps.pic_init_qp + r.se()
        # Deblocking: with no slice-level control flag in the PPS the
        # filter is implicitly ON (disable_deblocking_filter_idc defaults
        # to 0, spec 7.4.3); the fast tier never filters, so anything but
        # an explicit idc=1 must route to the scalar decoder.
        if not pps.deblocking_control:
            raise H264Unsupported(
                "deblocking-enabled slice unsupported (fast tier)")
        if r.ue() != 1:
            raise H264Unsupported(
                "deblocking-enabled slice unsupported (fast tier)")

        mbw, mbh = self.mbw, self.mbh
        n_total = mbw * mbh

        # ---- pass 1: parse ------------------------------------------------
        # per-MB coefficient stores (scan order; zigzag deferred to pass 2)
        N = n_total - first_mb
        kinds = np.zeros(N, np.uint8)  # 0 = I16, 1 = I_PCM
        qps = np.zeros(N, np.int64)
        l_dc = np.zeros((N, 16), np.int64)
        l_ac = np.zeros((N, 16, 15), np.int64)
        c_dc = np.zeros((N, 2, 4), np.int64)
        c_ac = np.zeros((N, 2, 4, 15), np.int64)
        pcm_y = {}
        pcm_c = {}

        mb_addr = None
        if os.environ.get("MIXLAB_PURE_H264_PYPARSE", "") != "1":
            mb_addr = self._parse_native(
                r, first_mb, qp, kinds, qps, l_dc, l_ac, c_dc, c_ac,
                pcm_y, pcm_c)
        if mb_addr is None:
            mb_addr = self._parse_python(
                r, first_mb, qp, kinds, qps, l_dc, l_ac, c_dc, c_ac,
                pcm_y, pcm_c)

        if mb_addr != n_total:
            raise H264DecodeError(
                f"slice ended after {mb_addr}/{n_total} macroblocks"
            )
        self._transform(first_mb, N, kinds, qps, l_dc, l_ac, c_dc, c_ac,
                        pcm_y, pcm_c)

    def _parse_native(self, r, first_mb, qp, kinds, qps, l_dc, l_ac, c_dc,
                      c_ac, pcm_y, pcm_c):
        """C++ pass 1 (mixlab_native.cpp h264_parse_slice), bit-identical to
        :meth:`_parse_python`; returns None when the library is missing so
        the caller falls back."""
        from mixlab_tpu_torch import native

        N = kinds.shape[0]
        pcm = np.zeros((N, 384), np.uint8)
        state = np.zeros(3, np.int64)
        code = native.h264_parse_slice(
            bytes(r.data) + b"\0" * 8, len(r.data), r.pos, first_mb,
            self.mbw, self.mbh, qp, _TABLES_PACKED,
            kinds, qps, l_dc, l_ac, c_dc, c_ac, pcm, state)
        if code is None:
            return None
        if code != 0:
            raise _native_error(code, int(state[2]))
        r.pos = int(state[0])
        for i in np.nonzero(kinds)[0]:
            raw = pcm[i].astype(np.int64)
            pcm_y[int(i)] = raw[:256].reshape(16, 16)
            pcm_c[int(i)] = raw[256:].reshape(2, 8, 8)
        return int(state[1])

    def _parse_python(self, r, first_mb, qp, kinds, qps, l_dc, l_ac, c_dc,
                      c_ac, pcm_y, pcm_c):
        fb = _FastBits(r.data)
        fb.pos = r.pos
        mbw, mbh = self.mbw, self.mbh
        n_total = mbw * mbh

        # nnz context as plain lists (parse-time only)
        nnz_y = [[-1] * (mbw * 4) for _ in range(mbh * 4)]
        nnz_u = [[-1] * (mbw * 2) for _ in range(mbh * 2)]
        nnz_v = [[-1] * (mbw * 2) for _ in range(mbh * 2)]

        def nc_of(nnz, mx, my, bx, by, grid):
            tx, ty = mx * grid + bx, my * grid + by
            nA = nnz[ty][tx - 1] if tx > 0 else -1
            nB = nnz[ty - 1][tx] if ty > 0 else -1
            if nA >= 0 and nB >= 0:
                return (nA + nB + 1) >> 1
            if nA >= 0:
                return nA
            if nB >= 0:
                return nB
            return 0

        mb_addr = first_mb
        while mb_addr < n_total and fb.more_rbsp_data():
            i = mb_addr - first_mb
            mx, my = mb_addr % mbw, mb_addr // mbw
            mb_type = fb.ue()
            if mb_type == 25:  # I_PCM
                fb.byte_align()
                at = fb.pos >> 3
                raw = np.frombuffer(
                    fb.data[at : at + 384], np.uint8
                ).astype(np.int64)
                if raw.size < 384:
                    raise H264DecodeError("truncated I_PCM")
                fb.pos += 384 * 8
                kinds[i] = 1
                # the mb_qp_delta chain is NOT reset by I_PCM (verified
                # against libavcodec; see h264dec._decode_mb)
                pcm_y[i] = raw[:256].reshape(16, 16)
                pcm_c[i] = raw[256:].reshape(2, 8, 8)
                for ty in range(my * 4, my * 4 + 4):
                    for tx in range(mx * 4, mx * 4 + 4):
                        nnz_y[ty][tx] = 16
                for ty in range(my * 2, my * 2 + 2):
                    for tx in range(mx * 2, mx * 2 + 2):
                        nnz_u[ty][tx] = 16
                        nnz_v[ty][tx] = 16
                mb_addr += 1
                continue
            if not 1 <= mb_type <= 24:
                raise H264Unsupported(
                    f"mb_type {mb_type} unsupported (Intra_16x16/I_PCM only)"
                )
            code = mb_type - 1
            pred_mode = code % 4
            cbp_chroma = (code // 4) % 3
            cbp_luma = 15 if code >= 12 else 0
            if pred_mode != 2:
                raise H264Unsupported(
                    f"Intra_16x16 prediction mode {pred_mode} unsupported "
                    "(DC only)"
                )
            if fb.ue() != 0:
                raise H264Unsupported(
                    "chroma prediction mode != DC unsupported"
                )
            # mb_qp_delta chains mod 52 (spec 7.4.5; scalar oracle at
            # h264dec._decode_mb)
            qp = (qp + fb.se() + 52) % 52
            qps[i] = qp

            # luma DC
            nC = nc_of(nnz_y, mx, my, 0, 0, 4)
            _read_block_fast(fb, nC, 16, l_dc[i])

            # luma AC
            if cbp_luma:
                row = l_ac[i]
                for bi in range(16):
                    bx, by = _BLK_POS[bi]
                    nC = nc_of(nnz_y, mx, my, bx, by, 4)
                    t = _read_block_fast(fb, nC, 15, row[bi])
                    nnz_y[my * 4 + by][mx * 4 + bx] = t
            else:
                for ty in range(my * 4, my * 4 + 4):
                    for tx in range(mx * 4, mx * 4 + 4):
                        nnz_y[ty][tx] = 0

            # chroma DC
            if cbp_chroma:
                _read_block_fast(fb, -1, 4, c_dc[i, 0])
                _read_block_fast(fb, -1, 4, c_dc[i, 1])
            # chroma AC
            for comp, nnz_c in ((0, nnz_u), (1, nnz_v)):
                if cbp_chroma == 2:
                    row = c_ac[i, comp]
                    for bi in range(4):
                        bx, by = bi % 2, bi // 2
                        nC = nc_of(nnz_c, mx, my, bx, by, 2)
                        t = _read_block_fast(fb, nC, 15, row[bi])
                        nnz_c[my * 2 + by][mx * 2 + bx] = t
                else:
                    for ty in range(my * 2, my * 2 + 2):
                        for tx in range(mx * 2, mx * 2 + 2):
                            nnz_c[ty][tx] = 0
            mb_addr += 1

        r.pos = fb.pos
        return mb_addr

    def _transform(self, first_mb, N, kinds, qps, l_dc, l_ac, c_dc, c_ac,
                   pcm_y, pcm_c):
        mbw, mbh = self.mbw, self.mbh

        # ---- pass 2: batched transforms ----------------------------------
        qp6, rem = np.divmod(qps, 6)
        va = _VA6[rem]  # [N]

        # luma DC: zigzag -> hadamard -> scale (spec 8.5.10)
        ZD = np.zeros((N, 16), np.int64)
        ZD[:, _ZIG] = l_dc
        FD = np.einsum("ij,njk,kl->nil", _H4, ZD.reshape(N, 4, 4), _H4)
        prod = FD * va[:, None, None]
        sh_hi = np.maximum(qp6 - 2, 0)[:, None, None]
        sh_lo = np.maximum(2 - qp6, 0)[:, None, None]
        f_lo = (1 << np.maximum(1 - qp6, 0))[:, None, None]
        dcY = np.where((qps >= 12)[:, None, None],
                       prod << sh_hi, (prod + f_lo) >> sh_lo)

        # luma AC: zigzag -> dequant -> insert DC -> idct
        ZA = np.zeros((N, 16, 16), np.int64)
        ZA[:, :, _ZIG_AC] = l_ac
        ZA = ZA.reshape(N, 16, 4, 4)
        DQ = (ZA * _V6[rem][:, None]) << qp6[:, None, None, None]
        DQ[:, np.arange(16), 0, 0] = dcY[:, _BY, _BX]
        res = (idct4x4(DQ) + 32) >> 6  # [N,16,4,4]
        # assemble 16x16 MBs: block bi sits at (4*_BY[bi], 4*_BX[bi])
        mb_y = np.zeros((N, 16, 16), np.int64)
        for bi in range(16):
            bx, by = _BLK_POS[bi]
            mb_y[:, 4 * by : 4 * by + 4, 4 * bx : 4 * bx + 4] = res[:, bi]

        # chroma: 2x2 DC hadamard + dequant (spec 8.5.11)
        qpc_i = np.clip(qps + self.pps.chroma_qp_offset, 0, 51)
        qpc = _QPC_MAP[qpc_i]
        cqp6, crem = np.divmod(qpc, 6)
        CZD = c_dc.reshape(N, 2, 2, 2)
        CF2 = np.einsum("ij,ncjk,kl->ncil", _H2, CZD, _H2)
        dcC = ((CF2 * _VA6[crem][:, None, None, None]) <<
               cqp6[:, None, None, None]) >> 1
        CZA = np.zeros((N, 2, 4, 16), np.int64)
        CZA[:, :, :, _ZIG_AC] = c_ac
        CZA = CZA.reshape(N, 2, 4, 4, 4)
        CDQ = (CZA * _V6[crem][:, None, None]) << cqp6[:, None, None, None,
                                                       None]
        ci = np.arange(4)
        CDQ[:, :, ci, 0, 0] = dcC.reshape(N, 2, 4)[:, :, ci]
        cres = (idct4x4(CDQ) + 32) >> 6  # [N,2,4,4,4]
        mb_c = np.zeros((N, 2, 8, 8), np.int64)
        for bi in range(4):
            sy, sx = 4 * (bi // 2), 4 * (bi % 2)
            mb_c[:, :, sy : sy + 4, sx : sx + 4] = cres[:, :, bi]

        # overwrite I_PCM macroblock contents (their "residual + pred" is
        # just the raw samples)
        pcm_idx = np.nonzero(kinds)[0]

        # ---- pass 2b: DC prediction + reconstruction ----------------------
        # native sequential recon when available (mixlab_native.cpp
        # h264_dc_recon, mirrors the scalar oracle); otherwise the Python
        # anti-diagonal wavefront below.  first_mb is always 0 here —
        # decode_slice rejects anything else with H264Unsupported.
        if os.environ.get("MIXLAB_PURE_H264_PYPARSE", "") != "1":
            from mixlab_tpu_torch import native

            pcm_buf = np.zeros((N, 384), np.uint8)
            for i in pcm_idx:
                pcm_buf[i, :256] = pcm_y[int(i)].ravel()
                pcm_buf[i, 256:] = pcm_c[int(i)].ravel()
            if native.h264_dc_recon(mb_y, mb_c, kinds, pcm_buf,
                                    first_mb, mbw, mbh,
                                    self.ry, self.ru, self.rv):
                return

        # DC prediction consumes only neighbor-edge SUMS, so carry running
        # bottom-row/right-col sums per MB and batch each anti-diagonal.
        rec_y = np.empty((N, 16, 16), np.int64)
        rec_c = np.empty((N, 2, 8, 8), np.int64)
        if pcm_idx.size:
            for i in pcm_idx:
                rec_y[i] = pcm_y[int(i)]
                rec_c[i] = pcm_c[int(i)]

        # running edge sums
        bot_y = np.zeros(N, np.int64)   # sum of bottom row (luma)
        rgt_y = np.zeros(N, np.int64)   # sum of right col (luma)
        bot_c = np.zeros((N, 2, 2), np.int64)  # per comp, per 4-col half
        rgt_c = np.zeros((N, 2, 2), np.int64)  # per comp, per 4-row half

        idx_grid = np.arange(N).reshape(mbh, mbw)
        for d in range(mbw + mbh - 1):
            mxs = np.arange(max(0, d - mbh + 1), min(d, mbw - 1) + 1)
            mys = d - mxs
            ids = idx_grid[mys, mxs]
            has_top = mys > 0
            has_left = mxs > 0
            top_ids = np.where(has_top, ids - mbw, 0)
            left_ids = np.where(has_left, ids - 1, 0)

            # luma pred (spec 8.3.3): sums over the 16-pel edges
            ts = bot_y[top_ids]
            ls = rgt_y[left_ids]
            pred = np.where(
                has_top & has_left, (ts + ls + 16) >> 5,
                np.where(has_top, (ts + 8) >> 4,
                         np.where(has_left, (ls + 8) >> 4, 128)))
            blk = np.clip(mb_y[ids] + pred[:, None, None], 0, 255)

            # chroma pred per 4x4 quadrant (spec 8.3.4, as in
            # h264dec._dc_pred_chroma)
            cts = bot_c[top_ids]   # [k,2,2] top halves (sx=0, sx=4)
            cls_ = rgt_c[left_ids]  # [k,2,2] left halves (sy=0, sy=4)
            ht = has_top[:, None]
            hl = has_left[:, None]
            t0, t1 = cts[:, :, 0], cts[:, :, 1]
            l0, l1 = cls_[:, :, 0], cls_[:, :, 1]
            q00 = np.where(ht & hl, (t0 + l0 + 4) >> 3,
                           np.where(ht, (t0 + 2) >> 2,
                                    np.where(hl, (l0 + 2) >> 2, 128)))
            q10 = np.where(ht, (t1 + 2) >> 2,
                           np.where(hl, (l0 + 2) >> 2, 128))
            q01 = np.where(hl, (l1 + 2) >> 2,
                           np.where(ht, (t0 + 2) >> 2, 128))
            q11 = np.where(ht & hl, (t1 + l1 + 4) >> 3,
                           np.where(ht, (t1 + 2) >> 2,
                                    np.where(hl, (l1 + 2) >> 2, 128)))
            cpred = np.empty((len(ids), 2, 8, 8), np.int64)
            cpred[:, :, :4, :4] = q00[:, :, None, None]
            cpred[:, :, :4, 4:] = q10[:, :, None, None]
            cpred[:, :, 4:, :4] = q01[:, :, None, None]
            cpred[:, :, 4:, 4:] = q11[:, :, None, None]
            cblk = np.clip(mb_c[ids] + cpred, 0, 255)

            # I_PCM MBs keep their raw samples
            pcm_here = kinds[ids] == 1
            if pcm_here.any():
                blk = np.where(pcm_here[:, None, None], rec_y[ids], blk)
                cblk = np.where(pcm_here[:, None, None, None],
                                rec_c[ids], cblk)

            rec_y[ids] = blk
            rec_c[ids] = cblk
            bot_y[ids] = blk[:, -1, :].sum(1)
            rgt_y[ids] = blk[:, :, -1].sum(1)
            bot_c[ids] = cblk[:, :, -1, :].reshape(-1, 2, 2, 4).sum(-1)
            rgt_c[ids] = cblk[:, :, :, -1].reshape(-1, 2, 2, 4).sum(-1)

        # assemble planes in one reshape
        self.ry[:, :] = (rec_y.reshape(mbh, mbw, 16, 16)
                         .transpose(0, 2, 1, 3).reshape(mbh * 16, mbw * 16))
        cc = (rec_c.reshape(mbh, mbw, 2, 8, 8)
              .transpose(2, 0, 3, 1, 4).reshape(2, mbh * 8, mbw * 8))
        self.ru[:, :] = cc[0]
        self.rv[:, :] = cc[1]

