"""Pure-Python H.264 decoder (zero dependencies): intra, P and B slices.

The port's copy of ``mixlab_tpu/av/h264dec.py``.

The inverse of the zero-dep encoder tier (av/h264cavlc.py + av/h264enc.py)
and a real-world decoder for what third-party encoders actually emit:

  * the FULL intra toolset — I_4x4 with all nine prediction modes,
    Intra_16x16 with all four, all four chroma modes, chained
    ``mb_qp_delta``, I_PCM — with CAVLC entropy here and CABAC via the
    sibling tier (av/h264cabac.py) feeding the same reconstruction;
  * INTER prediction: P slices with every mb_type and sub-8x8
    partition shape, quarter-sample motion compensation (av/h264mc.py),
    median MV prediction with the 16x8/8x16 directional shortcuts and
    P_Skip inference (8.4.1), a multi-picture DPB with sliding-window
    and MMCO-1 marking, reference list initialization + the full
    8.2.4.3.1 modification process, and explicit weighted prediction;
    B slices with spatial and temporal direct modes, B_Skip, bi-predicted
    partitions and explicit or implicit weighted bipred, emitted in
    display order;
  * the High profile's 8x8 transform and I_8x8 prediction (on the Python
    tiers; the native tiers hand such streams to them);
  * the §8.7 in-loop deblocking filter, with derived per-edge boundary
    strengths for inter pictures (8.7.2.1).

Three jobs:

  * an in-tree round-trip oracle for the pure encoder that is independent
    of libavcodec (tests decode our own streams and compare against the
    encoder's decoder-exact reconstruction, spec 8.5),
  * zero-dependency RTMP video ingest: ``PureH264Decoder`` is duck-type
    compatible with ``native/avshim.VideoDecoder`` (rtmp/mod.rs:260-338
    uses ffmpeg here; this build falls back to the pure tier on images
    with no codec libraries) and decodes default x264 output
    (profile=main, CABAC, inter), and
  * differential validation against libavcodec on real x264 streams:
    bit-exact planes across QP sweeps, deblock variants, adaptive-quant
    deltas (tests/test_h264dec_intra_full.py), and the full inter suite
    (tests/test_h264dec_inter.py).

Out of scope (rejected with a typed error, never mis-decoded): interlaced
(field) coding, scaling matrices, long-term references and MMCO other than
1, multi-slice pictures, slice groups, redundant pictures,
constrained_intra_pred inter slices, direct_8x8_inference_flag 0, and B
slices or implicit weighted bipred under pic_order_cnt_type 1.

Differences from the JAX package (each a fault of its copy, repaired here):
an SPS that changes the picture's macroblock dimensions clears the DPB, and
every reference of a slice's lists is checked against the active SPS's
plane shapes before any tier reads it (``_check_ref_shapes``), so a stream
that changes size can only raise ``H264DecodeError``, never read past a
stored picture; the native tier's Exp-Golomb reader takes up to 31 leading
zeros, as this module's reader does; a stream whose SPS has no VUI reorder
bound is held back for display order from its first picture unless its
profile is baseline (``PureH264Decoder._reorder_depth``).

Spec references: ITU-T H.264 §7.3 (syntax), §8.2.4/8.2.5 (lists, DPB),
§8.3 (intra prediction), §8.4 (inter prediction), §8.5
(transform/dequant), §8.7 (deblocking), §9.1/9.2 (Exp-Golomb, CAVLC).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

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
    _QPC,
    _V_A,
    dequant4x4,
    idct4x4,
)
from mixlab_tpu_torch.av.sps import SpsError, SpsInfo, _BitReader, parse_sps


class H264DecodeError(Exception):
    pass


class H264Unsupported(H264DecodeError):
    """Stream shape outside a decoder tier's scope — NOT corruption.

    Raised by ``FastSliceDecoder`` when a legitimate stream uses tools
    only the scalar full-intra decoder implements (I_4x4, non-DC
    prediction, deblocking, first_mb != 0); ``PureH264Decoder`` falls
    back to the scalar tier on exactly this type, never on message
    text."""


# ---------------------------------------------------------------------------
# bit reading
# ---------------------------------------------------------------------------


class BitReader(_BitReader):
    """sps.py's un-escaping reader plus the extras slice decoding needs."""

    def byte_align(self):
        self.pos = (self.pos + 7) & ~7

    def _stop_bit(self) -> int:
        """Position of the rbsp_stop_one_bit (the last set bit), cached —
        a per-macroblock rescan would be O(stream^2)."""
        cached = getattr(self, "_stop_bit_pos", None)
        if cached is not None:
            return cached
        last = len(self.data) * 8 - 1
        while last >= 0:
            byte = self.data[last >> 3]
            if (byte >> (7 - (last & 7))) & 1:
                break
            last -= 1
        self._stop_bit_pos = last
        return last

    def more_rbsp_data(self) -> bool:
        """True while bits other than the rbsp_stop_one_bit + padding
        remain (spec 7.2)."""
        return self.pos < self._stop_bit()


# ---------------------------------------------------------------------------
# inverted CAVLC tables (prefix-code decode maps keyed (length, bits))
# ---------------------------------------------------------------------------


def _invert(len_tab, bits_tab, value_of):
    m: Dict[Tuple[int, int], int] = {}
    for idx, (ln, bits) in enumerate(zip(len_tab, bits_tab)):
        if ln == 0 and idx != 0:
            continue  # unused entry
        if ln == 0:
            continue
        m[(ln, bits)] = value_of(idx)
    return m


_COEFF_TOKEN_DEC = tuple(
    _invert(COEFF_TOKEN_LEN[cls], COEFF_TOKEN_BITS[cls], lambda i: i)
    for cls in range(4)
)
_CHROMA_DC_TOKEN_DEC = _invert(
    CHROMA_DC_COEFF_TOKEN_LEN[0], CHROMA_DC_COEFF_TOKEN_BITS[0], lambda i: i
)
_TOTAL_ZEROS_DEC = tuple(
    _invert(TOTAL_ZEROS_LEN[t], TOTAL_ZEROS_BITS[t], lambda i: i)
    for t in range(16)
)
_CHROMA_DC_TZ_DEC = tuple(
    _invert(CHROMA_DC_TOTAL_ZEROS_LEN[t], CHROMA_DC_TOTAL_ZEROS_BITS[t],
            lambda i: i)
    for t in range(3)
)
_RUN_DEC = tuple(
    _invert(RUN_LEN[t], RUN_BITS[t], lambda i: i) for t in range(7)
)


def _read_prefix(r: BitReader, table: Dict[Tuple[int, int], int],
                 max_len: int = 16) -> int:
    bits = 0
    for ln in range(1, max_len + 1):
        bits = (bits << 1) | r.bit()
        v = table.get((ln, bits))
        if v is not None:
            return v
    raise H264DecodeError("bad prefix code")


def read_cavlc_block(r: BitReader, nC: int, max_coeff: int) -> List[int]:
    """Inverse of h264cavlc.write_cavlc_block: -> scan-order coefficient
    list of length ``max_coeff``."""
    if nC == -1:
        idx = _read_prefix(r, _CHROMA_DC_TOKEN_DEC, 8)
    else:
        cls = 0 if nC < 2 else 1 if nC < 4 else 2 if nC < 8 else 3
        idx = _read_prefix(r, _COEFF_TOKEN_DEC[cls], 16)
    total, t1s = idx // 4, idx % 4
    if total > max_coeff:
        raise H264DecodeError(
            f"coeff_token total {total} exceeds block size {max_coeff}")
    coeffs = [0] * max_coeff
    if total == 0:
        return coeffs

    levels: List[int] = []  # highest-frequency first
    for _ in range(t1s):
        levels.append(-1 if r.bit() else 1)

    suffix_len = 1 if (total > 10 and t1s < 3) else 0
    first = True
    for _ in range(total - t1s):
        prefix = 0
        while r.bit() == 0:
            prefix += 1
            if prefix > 15:
                raise H264DecodeError("level prefix overflow")
        if suffix_len == 0:
            if prefix < 14:
                level_code = prefix
            elif prefix == 14:
                level_code = 14 + r.bits(4)
            else:
                level_code = 30 + r.bits(12)
        else:
            if prefix < 14:
                level_code = (prefix << suffix_len) + r.bits(suffix_len)
            elif prefix == 14:
                level_code = (14 << suffix_len) + r.bits(suffix_len)
            else:
                level_code = (15 << suffix_len) + r.bits(12)
        if first and t1s < 3:
            level_code += 2
        first = False
        lev = (level_code >> 1) + 1
        if level_code & 1:
            lev = -lev
        levels.append(lev)
        if suffix_len == 0:
            suffix_len = 1
        if abs(lev) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1

    if total < max_coeff:
        if max_coeff == 4:  # chroma DC
            tz = _read_prefix(r, _CHROMA_DC_TZ_DEC[total - 1], 8)
        else:
            tz = _read_prefix(r, _TOTAL_ZEROS_DEC[total - 1], 16)
    else:
        tz = 0
    if total + tz > max_coeff:
        raise H264DecodeError(
            f"total_zeros {tz} + total {total} exceeds block size {max_coeff}")

    # positions, highest-frequency coefficient first
    pos = [0] * total
    zeros_left = tz
    pos[total - 1] = total - 1 + tz
    for k in range(total - 1, 0, -1):
        if zeros_left > 0:
            run = _read_prefix(r, _RUN_DEC[min(zeros_left, 7) - 1], 16)
            if run > zeros_left:
                raise H264DecodeError(
                    f"run_before {run} exceeds zeros_left {zeros_left}")
        else:
            run = 0
        pos[k - 1] = pos[k] - run - 1
        zeros_left -= run

    # levels[0] belongs to the highest position
    for i, lev in enumerate(levels):
        coeffs[pos[total - 1 - i]] = lev
    return coeffs


# ---------------------------------------------------------------------------
# parameter sets / slice header
# ---------------------------------------------------------------------------


class _Pps:
    def __init__(self, rbsp: bytes):
        r = BitReader(rbsp)
        self.id = r.ue()
        self.sps_id = r.ue()
        # entropy_coding_mode_flag: CABAC slices decode via the sibling
        # av/h264cabac.py tier, CAVLC via this module
        self.entropy_cabac = bool(r.bit())
        self.bottom_field_poc = r.bit()
        if r.ue() != 0:
            raise H264DecodeError("slice groups unsupported")
        self.num_ref_idx_l0 = r.ue() + 1
        self.num_ref_idx_l1 = r.ue() + 1
        self.weighted_pred = bool(r.bit())
        self.weighted_bipred_idc = r.bits(2)
        self.pic_init_qp = 26 + r.se()
        r.se()  # pic_init_qs
        self.chroma_qp_offset = r.se()
        self.chroma_qp_offset2 = self.chroma_qp_offset  # Cr (7.4.2.2)
        self.deblocking_control = r.bit()
        self.constrained_intra_pred = bool(r.bit())
        self.redundant_pic_cnt_present = bool(r.bit())
        self.transform_8x8 = False
        if r.more_rbsp_data():  # PPS extension (7.3.2.2)
            self.transform_8x8 = bool(r.bit())
            if r.bit():
                raise H264DecodeError("scaling matrices unsupported")
            self.chroma_qp_offset2 = r.se()


def _parse_vui_reorder(r: BitReader) -> Optional[int]:
    """Walk VUI parameters (spec E.1.1) far enough to read
    max_num_reorder_frames; None when bitstream_restriction is absent."""

    def hrd():
        cpb_cnt = r.ue() + 1
        if cpb_cnt > 32:
            raise H264DecodeError("bad HRD cpb_cnt")
        r.bits(8)
        for _ in range(cpb_cnt):
            r.ue(), r.ue(), r.bit()
        r.bits(20)

    if r.bit():  # aspect_ratio_info
        if r.bits(8) == 255:
            r.bits(32)
    if r.bit():  # overscan_info
        r.bit()
    if r.bit():  # video_signal_type
        r.bits(4)
        if r.bit():
            r.bits(24)
    if r.bit():  # chroma_loc_info
        r.ue(), r.ue()
    if r.bit():  # timing_info
        r.bits(65)
    nal_hrd = r.bit()
    if nal_hrd:
        hrd()
    vcl_hrd = r.bit()
    if vcl_hrd:
        hrd()
    if nal_hrd or vcl_hrd:
        r.bit()  # low_delay_hrd
    r.bit()  # pic_struct_present
    if not r.bit():  # bitstream_restriction_flag
        return None
    r.bit()
    r.ue(), r.ue(), r.ue(), r.ue()
    return r.ue()  # max_num_reorder_frames


class _SpsExt:
    """SPS fields the slice header consumes beyond SpsInfo."""

    def __init__(self, rbsp: bytes):
        self.info: SpsInfo = parse_sps(rbsp)
        # re-parse the few position-dependent fields we need
        r = BitReader(rbsp)
        profile_idc = r.bits(8)
        r.bits(8)
        r.bits(8)
        r.ue()
        if profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138,
                           139, 134, 135):
            cf = r.ue()
            if cf == 3:
                r.bit()
            r.ue()
            r.ue()
            r.bit()
            if r.bit():
                raise H264DecodeError("scaling matrices unsupported")
        self.log2_max_frame_num = r.ue() + 4
        self.poc_type = r.ue()
        self.log2_max_poc_lsb = 0
        self.delta_poc_always_zero = False
        self.num_ref_frames_in_poc_cycle = 0
        if self.poc_type == 0:
            self.log2_max_poc_lsb = r.ue() + 4
        elif self.poc_type == 1:
            self.delta_poc_always_zero = bool(r.bit())
            r.se()
            r.se()
            self.num_ref_frames_in_poc_cycle = r.ue()
            for _ in range(self.num_ref_frames_in_poc_cycle):
                r.se()
        self.max_num_ref_frames = r.ue()
        self.gaps_allowed = bool(r.bit())
        self.mb_width = r.ue() + 1
        self.mb_height = r.ue() + 1
        # cap allocations on untrusted input (RTMP ingest): same ceiling
        # as native/avshim.VideoDecoder max_pixels; a corrupted SPS must
        # raise the typed error, not attempt a monster plane allocation
        if self.mb_width * self.mb_height * 256 > 4096 * 2304:
            raise H264DecodeError(
                f"picture {self.mb_width * 16}x{self.mb_height * 16} "
                "exceeds the decoder pixel cap")
        if not r.bit():
            raise H264DecodeError("interlaced streams unsupported")
        self.direct_8x8_inference = bool(r.bit())
        if r.bit():  # frame_cropping (sizes come from SpsInfo)
            r.ue(), r.ue(), r.ue(), r.ue()
        # VUI: only max_num_reorder_frames matters here (B-picture output
        # delay); None when VUI/bitstream_restriction is absent
        self.num_reorder_frames: Optional[int] = None
        if r.bit():  # vui_parameters_present_flag
            try:
                self.num_reorder_frames = _parse_vui_reorder(r)
            except (SpsError, H264DecodeError):
                # decoding never NEEDED the VUI before this field existed;
                # a malformed one degrades to the conservative default
                self.num_reorder_frames = None


# ---------------------------------------------------------------------------
# decoded picture buffer (spec 8.2.4/8.2.5, frame coding, short-term only)
# ---------------------------------------------------------------------------


class RefPic:
    """One stored reference picture: FULL (MB-aligned, uncropped) planes —
    unrestricted MVs reference the area beyond the crop window, clamped at
    the full picture edge (8.4.2.2.1) — plus the POC and the per-4x4
    co-located motion B direct modes consult (8.4.1.2.2/8.4.1.2.3):
    ``mv[gy, gx, lx, comp]``, the raw ``refidx`` (colZeroFlag needs
    refIdxCol == 0), and the referenced picture's identity (``refpid``)
    and POC (``refpoc``).  ``mv`` is None for pictures decoded by a tier
    that does not export motion (a later B direct raises a typed
    error)."""

    __slots__ = ("pid", "frame_num", "poc", "y", "u", "v",
                 "mv", "refidx", "refpid", "refpoc", "intra_only")

    def __init__(self, pid, frame_num, y, u, v, poc=0, motion=None):
        self.pid = pid
        self.frame_num = frame_num
        self.poc = poc
        self.y, self.u, self.v = y, u, v
        self.intra_only = motion == "intra"
        if motion is not None and not self.intra_only:
            self.mv, self.refidx, self.refpid, self.refpoc = motion
        else:
            self.mv = self.refidx = self.refpid = self.refpoc = None


class Dpb:
    """Short-term reference bookkeeping: sliding window (8.2.5.3), MMCO 1
    (8.2.5.4.1), P list0 initialization by descending PicNum (8.2.4.2.1),
    B list0/list1 initialization by POC order (8.2.4.2.3), the short-term
    re-ordering process (8.2.4.3.1), and the cross-picture POC predictor
    state (8.2.1).  Long-term references raise typed errors (x264 never
    emits them; the libavcodec shim covers such streams)."""

    def __init__(self):
        self.pics: List[RefPic] = []
        self._next_pid = 0
        # POC predictor state (8.2.1.1 / 8.2.1.3)
        self.prev_poc_msb = 0
        self.prev_poc_lsb = 0
        self.prev_fno = 0
        self.prev_frame_num = 0

    def clear(self):
        self.pics.clear()

    def store(self, frame_num: int, y, u, v, max_refs: int,
              poc: int = 0, motion=None):
        """Sliding-window decoded reference picture marking (8.2.5.3)."""
        pic = RefPic(self._next_pid, frame_num, y, u, v, poc, motion)
        self._next_pid += 1
        self.pics.append(pic)
        while len(self.pics) > max(max_refs, 1):
            self.pics.pop(0)  # decode order == FrameNumWrap order here

    def mmco_forget_short(self, pic_num: int, cur_frame_num: int,
                          max_frame_num: int):
        """MMCO 1: mark a short-term picture unused (8.2.5.4.1)."""
        for i, p in enumerate(self.pics):
            if self._pic_num(p, cur_frame_num, max_frame_num) == pic_num:
                del self.pics[i]
                return
        raise H264DecodeError(f"MMCO 1: no short-term pic_num {pic_num}")

    @staticmethod
    def _pic_num(pic: RefPic, cur_frame_num: int, max_frame_num: int) -> int:
        fn = pic.frame_num
        return fn if fn <= cur_frame_num else fn - max_frame_num

    def init_list_p(self, cur_frame_num: int, max_frame_num: int):
        """RefPicList0 before modification: short-term refs by descending
        PicNum (8.2.4.2.1)."""
        return sorted(
            self.pics,
            key=lambda p: -self._pic_num(p, cur_frame_num, max_frame_num),
        )

    def init_lists_b(self, cur_poc: int):
        """RefPicList0/RefPicList1 before modification for a B slice
        (8.2.4.2.3, frame coding, short-term only): list0 = past refs by
        descending POC then future refs by ascending POC; list1 the
        mirror; if the lists come out identical with more than one entry,
        the first two of list1 swap."""
        past = sorted((p for p in self.pics if p.poc < cur_poc),
                      key=lambda p: -p.poc)
        future = sorted((p for p in self.pics if p.poc > cur_poc),
                        key=lambda p: p.poc)
        l0 = past + future
        l1 = future + past
        if len(l1) > 1 and l0 == l1:
            l1[0], l1[1] = l1[1], l0[0]
        return l0, l1


# ---------------------------------------------------------------------------
# macroblock reconstruction (mirrors the encoder's decoder-exact recon)
# ---------------------------------------------------------------------------


def _dc_pred16(recon, y0, x0, has_top, has_left) -> int:
    if has_top and has_left:
        return (int(recon[y0 - 1, x0 : x0 + 16].sum())
                + int(recon[y0 : y0 + 16, x0 - 1].sum()) + 16) >> 5
    if has_top:
        return (int(recon[y0 - 1, x0 : x0 + 16].sum()) + 8) >> 4
    if has_left:
        return (int(recon[y0 : y0 + 16, x0 - 1].sum()) + 8) >> 4
    return 128


def _dc_pred_chroma(recon, y0, x0, has_top, has_left) -> np.ndarray:
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
            else:
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


# coded_block_pattern me(v) mapping for intra MBs (Table 9-4,
# ChromaArrayType=1): codeNum -> cbp
_CBP_INTRA = (47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46,
              16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4,
              8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41)

# Table 9-4 Inter column (ChromaArrayType=1): codeNum -> cbp.  Validated
# behaviorally: any error here breaks the bit-exact differentials vs
# libavcodec in tests/test_h264dec_inter.py on the first coded P-MB.
_CBP_INTER = (0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
              14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
              17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41)

# P-macroblock partition shapes by mb_type (Table 7-13): (px, py, w, h)
# in luma samples relative to the MB corner
_P_PARTS = {
    0: ((0, 0, 16, 16),),
    1: ((0, 0, 16, 8), (0, 8, 16, 8)),
    2: ((0, 0, 8, 16), (8, 0, 8, 16)),
}

# sub-macroblock partition shapes by sub_mb_type (Table 7-17), relative
# to the 8x8 block corner
_P_SUB_PARTS = {
    0: ((0, 0, 8, 8),),
    1: ((0, 0, 8, 4), (0, 4, 8, 4)),
    2: ((0, 0, 4, 8), (4, 0, 4, 8)),
    3: ((0, 0, 4, 4), (4, 0, 4, 4), (0, 4, 4, 4), (4, 4, 4, 4)),
}

# B macroblock types 1..21 (Table 7-14): shape key into _P_PARTS plus a
# per-partition prediction mask (1 = list0, 2 = list1, 3 = bi)
_B_MODES = {
    1: (0, (1,)), 2: (0, (2,)), 3: (0, (3,)),
    4: (1, (1, 1)), 5: (2, (1, 1)), 6: (1, (2, 2)), 7: (2, (2, 2)),
    8: (1, (1, 2)), 9: (2, (1, 2)), 10: (1, (2, 1)), 11: (2, (2, 1)),
    12: (1, (1, 3)), 13: (2, (1, 3)), 14: (1, (2, 3)), 15: (2, (2, 3)),
    16: (1, (3, 1)), 17: (2, (3, 1)), 18: (1, (3, 2)), 19: (2, (3, 2)),
    20: (1, (3, 3)), 21: (2, (3, 3)),
}

# B sub_mb_type 1..12 (Table 7-18): shape key into _P_SUB_PARTS + mask;
# sub_mb_type 0 is B_Direct_8x8
_B_SUB = {
    1: (0, 1), 2: (0, 2), 3: (0, 3),
    4: (1, 1), 5: (2, 1), 6: (1, 2), 7: (2, 2), 8: (1, 3), 9: (2, 3),
    10: (3, 1), 11: (3, 2), 12: (3, 3),
}


def _median3(a: int, b: int, c: int) -> int:
    return a + b + c - min(a, b, c) - max(a, b, c)

# luma (bx, by) -> decode-order index (inverse of _BLK_POS)
_Z_OF = {pos: i for i, pos in enumerate(_BLK_POS)}


def _pred4x4(recon, y0, x0, mode, has_top, has_left, has_tr) -> np.ndarray:
    """Intra_4x4 prediction (spec 8.3.1.2); ``recon`` is the int64 luma
    plane, (y0, x0) the block's top-left sample."""
    top = left = None
    corner = 0
    if has_top:
        top = recon[y0 - 1, x0 : x0 + 4].astype(np.int64)
        if has_tr:
            tr = recon[y0 - 1, x0 + 4 : x0 + 8].astype(np.int64)
        else:
            # p[4..7,-1] unavailable -> substitute p[3,-1] (8.3.1.2 note)
            tr = np.full(4, top[3], np.int64)
        t = np.concatenate([top, tr])  # t[i] = p[i,-1], i 0..7
    if has_left:
        left = recon[y0 : y0 + 4, x0 - 1].astype(np.int64)
    if has_top and has_left:
        corner = int(recon[y0 - 1, x0 - 1])

    pred = np.empty((4, 4), np.int64)
    if mode == 2:  # DC
        if has_top and has_left:
            pred[:] = (int(top.sum()) + int(left.sum()) + 4) >> 3
        elif has_top:
            pred[:] = (int(top.sum()) + 2) >> 2
        elif has_left:
            pred[:] = (int(left.sum()) + 2) >> 2
        else:
            pred[:] = 128
        return pred
    if mode == 0:  # Vertical
        if not has_top:
            raise H264DecodeError("intra4x4 V without top")
        pred[:] = top[None, :]
        return pred
    if mode == 1:  # Horizontal
        if not has_left:
            raise H264DecodeError("intra4x4 H without left")
        pred[:] = left[:, None]
        return pred
    if mode == 3:  # Diagonal-Down-Left
        if not has_top:
            raise H264DecodeError("intra4x4 DDL without top")
        for y in range(4):
            for x in range(4):
                if x == 3 and y == 3:
                    pred[y, x] = (t[6] + 3 * t[7] + 2) >> 2
                else:
                    i = x + y
                    pred[y, x] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
        return pred
    if mode == 7:  # Vertical-Left
        if not has_top:
            raise H264DecodeError("intra4x4 VL without top")
        for y in range(4):
            for x in range(4):
                i = x + (y >> 1)
                if y % 2 == 0:
                    pred[y, x] = (t[i] + t[i + 1] + 1) >> 1
                else:
                    pred[y, x] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
        return pred
    if mode == 8:  # Horizontal-Up
        if not has_left:
            raise H264DecodeError("intra4x4 HU without left")
        for y in range(4):
            for x in range(4):
                z = x + 2 * y
                if z in (0, 2, 4):
                    i = y + (x >> 1)
                    pred[y, x] = (left[i] + left[i + 1] + 1) >> 1
                elif z in (1, 3):
                    i = y + (x >> 1)
                    pred[y, x] = (
                        left[i] + 2 * left[i + 1] + left[i + 2] + 2
                    ) >> 2
                elif z == 5:
                    pred[y, x] = (left[2] + 3 * left[3] + 2) >> 2
                else:
                    pred[y, x] = left[3]
        return pred
    # remaining modes need top, left and the corner
    if not (has_top and has_left):
        raise H264DecodeError(f"intra4x4 mode {mode} without neighbors")
    if mode == 4:  # Diagonal-Down-Right
        for y in range(4):
            for x in range(4):
                if x > y:
                    pred[y, x] = (
                        t[x - y - 2] + 2 * t[x - y - 1] + t[x - y] + 2
                    ) >> 2 if x - y >= 2 else (
                        corner + 2 * t[0] + t[1] + 2
                    ) >> 2 if x - y == 1 else 0
                elif x < y:
                    pred[y, x] = (
                        left[y - x - 2] + 2 * left[y - x - 1] + left[y - x]
                        + 2
                    ) >> 2 if y - x >= 2 else (
                        corner + 2 * left[0] + left[1] + 2
                    ) >> 2 if y - x == 1 else 0
                else:
                    pred[y, x] = (t[0] + 2 * corner + left[0] + 2) >> 2
        return pred
    if mode == 5:  # Vertical-Right
        for y in range(4):
            for x in range(4):
                z = 2 * x - y
                i = x - (y >> 1)
                if z in (0, 2, 4, 6):
                    a = corner if i - 1 < 0 else t[i - 1]
                    pred[y, x] = (a + t[i] + 1) >> 1
                elif z in (1, 3, 5):
                    a = corner if i - 2 < 0 else t[i - 2]
                    b = corner if i - 1 < 0 else t[i - 1]
                    pred[y, x] = (a + 2 * b + t[i] + 2) >> 2
                elif z == -1:
                    pred[y, x] = (left[0] + 2 * corner + t[0] + 2) >> 2
                else:  # -2, -3: (x,y) = (0,2) or (0,3); y-3 == -1 -> corner
                    c = corner if y - 3 < 0 else left[y - 3]
                    pred[y, x] = (
                        left[y - 1] + 2 * left[y - 2] + c + 2
                    ) >> 2
        return pred
    if mode == 6:  # Horizontal-Down
        for y in range(4):
            for x in range(4):
                z = 2 * y - x
                i = y - (x >> 1)
                if z in (0, 2, 4, 6):
                    a = corner if i - 1 < 0 else left[i - 1]
                    pred[y, x] = (a + left[i] + 1) >> 1
                elif z in (1, 3, 5):
                    a = corner if i - 2 < 0 else left[i - 2]
                    b = corner if i - 1 < 0 else left[i - 1]
                    pred[y, x] = (a + 2 * b + left[i] + 2) >> 2
                elif z == -1:
                    pred[y, x] = (left[0] + 2 * corner + t[0] + 2) >> 2
                else:  # -2, -3: (x,y) = (2,0) or (3,0); x-3 == -1 -> corner
                    c = corner if x - 3 < 0 else t[x - 3]
                    pred[y, x] = (
                        t[x - 1] + 2 * t[x - 2] + c + 2
                    ) >> 2
        return pred
    raise H264DecodeError(f"intra4x4 prediction mode {mode} invalid")


# ---------------------------------------------------------------------------
# 8x8 transform tools (High profile, spec 8.3.2 / 8.5.13): Intra_8x8
# prediction with reference-sample filtering, flat-matrix dequant, and
# the 8-point butterfly inverse transform
# ---------------------------------------------------------------------------

# 8x8 frame zigzag (same scan as JPEG's; spec Table 8-8 column 0)
ZIGZAG8 = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)

# dequant class per (i & 3, j & 3) and per-class factors by qp % 6
# (flat weightScale 16 folded in; spec 8.5.13.1 normAdjust8x8)
_D8_CLASS = (0, 3, 4, 3, 3, 1, 5, 1, 4, 5, 2, 5, 3, 1, 5, 1)
_D8_FACT = ((20, 18, 32, 19, 25, 24), (22, 19, 35, 21, 28, 26),
            (26, 23, 42, 24, 33, 31), (28, 25, 45, 26, 35, 33),
            (32, 28, 51, 30, 40, 38), (36, 32, 58, 34, 46, 43))
_D8_MATS = []
for _m in range(6):
    _mat = np.empty((8, 8), np.int64)
    for _i in range(8):
        for _j in range(8):
            _mat[_i, _j] = _D8_FACT[_m][_D8_CLASS[(_i & 3) * 4 + (_j & 3)]]
    _D8_MATS.append(_mat)
_D8_MATS = tuple(_D8_MATS)


def dequant8x8(Z: np.ndarray, qp: int) -> np.ndarray:
    """Flat-matrix 8x8 dequantization (spec 8.5.13.1 with the flat
    weightScale 16 folded: LevelScale8x8 = 16 * normAdjust8x8, so the
    spec's qP/6 - 6 shift becomes qP/6 - 2); Z is [..., 8, 8] raster
    coefficients."""
    qp6, rem = divmod(qp, 6)
    ls = _D8_MATS[rem]
    if qp6 >= 2:
        return (Z * ls) << (qp6 - 2)
    return (Z * ls + (1 << (1 - qp6))) >> (2 - qp6)


def _idct8_pass(s: np.ndarray) -> np.ndarray:
    """One 8-point butterfly (spec 8.5.13.2) along axis 0."""
    a0 = s[0] + s[4]
    a4 = s[0] - s[4]
    a2 = (s[2] >> 1) - s[6]
    a6 = s[2] + (s[6] >> 1)
    b0 = a0 + a6
    b2 = a4 + a2
    b4 = a4 - a2
    b6 = a0 - a6
    a1 = -s[3] + s[5] - s[7] - (s[7] >> 1)
    a3 = s[1] + s[7] - s[3] - (s[3] >> 1)
    a5 = -s[1] + s[7] + s[5] + (s[5] >> 1)
    a7 = s[3] + s[5] + s[1] + (s[1] >> 1)
    b1 = (a7 >> 2) + a1
    b3 = a3 + (a5 >> 2)
    b5 = (a3 >> 2) - a5
    b7 = a7 - (a1 >> 2)
    return np.stack([b0 + b7, b2 + b5, b4 + b3, b6 + b1,
                     b6 - b1, b4 - b3, b2 - b5, b0 - b7])


def idct8x8(blk: np.ndarray) -> np.ndarray:
    """8x8 inverse transform (spec 8.5.13.2): vertical column pass, then
    horizontal; the caller applies the final (x + 32) >> 6."""
    h = _idct8_pass(blk.T).T
    return _idct8_pass(h)


def _pred8x8(recon, y0, x0, mode, has_top, has_left, has_tr) -> np.ndarray:
    """Intra_8x8 prediction (spec 8.3.2.2): the reference samples are
    low-pass filtered first (8.3.2.2.1), then the nine modes mirror the
    4x4 equations at 8x8 scale."""
    has_corner = has_top and has_left
    t = l = None
    c = 0
    if has_top:
        top = recon[y0 - 1, x0: x0 + 8].astype(np.int64)
        if has_tr:
            tr = recon[y0 - 1, x0 + 8: x0 + 16].astype(np.int64)
        else:
            tr = np.full(8, top[7], np.int64)
        raw = np.concatenate([top, tr])  # p[0..15, -1]
        t = np.empty(16, np.int64)
        c_raw = int(recon[y0 - 1, x0 - 1]) if has_corner else 0
        t[0] = ((c_raw + 2 * raw[0] + raw[1] + 2) >> 2 if has_corner
                else (3 * raw[0] + raw[1] + 2) >> 2)
        t[1:15] = (raw[:14] + 2 * raw[1:15] + raw[2:] + 2) >> 2
        t[15] = (raw[14] + 3 * raw[15] + 2) >> 2
    if has_left:
        lraw = recon[y0: y0 + 8, x0 - 1].astype(np.int64)
        l = np.empty(8, np.int64)
        c_raw = int(recon[y0 - 1, x0 - 1]) if has_corner else 0
        l[0] = ((c_raw + 2 * lraw[0] + lraw[1] + 2) >> 2 if has_corner
                else (3 * lraw[0] + lraw[1] + 2) >> 2)
        l[1:7] = (lraw[:6] + 2 * lraw[1:7] + lraw[2:] + 2) >> 2
        l[7] = (lraw[6] + 3 * lraw[7] + 2) >> 2
    if has_corner:
        c_raw = int(recon[y0 - 1, x0 - 1])
        c = (int(recon[y0 - 1, x0]) + 2 * c_raw
             + int(recon[y0, x0 - 1]) + 2) >> 2

    def T(i):
        return c if i < 0 else int(t[i])

    def L(i):
        return c if i < 0 else int(l[i])

    pred = np.empty((8, 8), np.int64)
    if mode == 2:  # DC
        if has_top and has_left:
            pred[:] = (int(t[:8].sum()) + int(l.sum()) + 8) >> 4
        elif has_top:
            pred[:] = (int(t[:8].sum()) + 4) >> 3
        elif has_left:
            pred[:] = (int(l.sum()) + 4) >> 3
        else:
            pred[:] = 128
        return pred
    if mode == 0:  # Vertical
        if not has_top:
            raise H264DecodeError("intra8x8 V without top")
        pred[:] = t[None, :8]
        return pred
    if mode == 1:  # Horizontal
        if not has_left:
            raise H264DecodeError("intra8x8 H without left")
        pred[:] = l[:, None]
        return pred
    if mode == 3:  # Diagonal-Down-Left
        if not has_top:
            raise H264DecodeError("intra8x8 DDL without top")
        for y in range(8):
            for x in range(8):
                if x == 7 and y == 7:
                    pred[y, x] = (t[14] + 3 * t[15] + 2) >> 2
                else:
                    i = x + y
                    pred[y, x] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
        return pred
    if mode == 7:  # Vertical-Left
        if not has_top:
            raise H264DecodeError("intra8x8 VL without top")
        for y in range(8):
            for x in range(8):
                i = x + (y >> 1)
                if y % 2 == 0:
                    pred[y, x] = (t[i] + t[i + 1] + 1) >> 1
                else:
                    pred[y, x] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
        return pred
    if mode == 8:  # Horizontal-Up
        if not has_left:
            raise H264DecodeError("intra8x8 HU without left")
        for y in range(8):
            for x in range(8):
                z = x + 2 * y
                i = y + (x >> 1)
                if z < 13 and z % 2 == 0:
                    pred[y, x] = (l[i] + l[i + 1] + 1) >> 1
                elif z < 13:
                    pred[y, x] = (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2
                elif z == 13:
                    pred[y, x] = (l[6] + 3 * l[7] + 2) >> 2
                else:
                    pred[y, x] = l[7]
        return pred
    if not (has_top and has_left):
        raise H264DecodeError(f"intra8x8 mode {mode} without neighbors")
    if mode == 4:  # Diagonal-Down-Right
        for y in range(8):
            for x in range(8):
                if x > y:
                    pred[y, x] = (T(x - y - 2) + 2 * T(x - y - 1)
                                  + T(x - y) + 2) >> 2
                elif x < y:
                    pred[y, x] = (L(y - x - 2) + 2 * L(y - x - 1)
                                  + L(y - x) + 2) >> 2
                else:
                    pred[y, x] = (t[0] + 2 * c + l[0] + 2) >> 2
        return pred
    if mode == 5:  # Vertical-Right
        for y in range(8):
            for x in range(8):
                z = 2 * x - y
                i = x - (y >> 1)
                if z >= 0 and z % 2 == 0:
                    pred[y, x] = (T(i - 1) + T(i) + 1) >> 1
                elif z > 0:
                    pred[y, x] = (T(i - 2) + 2 * T(i - 1) + T(i) + 2) >> 2
                elif z == -1:
                    pred[y, x] = (l[0] + 2 * c + t[0] + 2) >> 2
                else:
                    pred[y, x] = (l[y - 2 * x - 1] + 2 * l[y - 2 * x - 2]
                                  + L(y - 2 * x - 3) + 2) >> 2
        return pred
    if mode == 6:  # Horizontal-Down
        for y in range(8):
            for x in range(8):
                z = 2 * y - x
                i = y - (x >> 1)
                if z >= 0 and z % 2 == 0:
                    pred[y, x] = (L(i - 1) + L(i) + 1) >> 1
                elif z > 0:
                    pred[y, x] = (L(i - 2) + 2 * L(i - 1) + L(i) + 2) >> 2
                elif z == -1:
                    pred[y, x] = (l[0] + 2 * c + t[0] + 2) >> 2
                else:
                    pred[y, x] = (t[x - 2 * y - 1] + 2 * t[x - 2 * y - 2]
                                  + T(x - 2 * y - 3) + 2) >> 2
        return pred
    raise H264DecodeError(f"intra8x8 prediction mode {mode} invalid")

_ALPHA = np.array(
    [0] * 16
    + [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36,
       40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182, 203,
       226, 255, 255],
    np.int64,
)
_BETA = np.array(
    [0] * 16
    + [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11,
       11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18],
    np.int64,
)
# Table 8-17: tc0 for bS 1..3 per indexA (zero for indexA <= 16;
# indexA 17..20 are all (0,0,1) — ffmpeg/x264 tc0_table agrees)
_TC0 = np.array(
    [[0, 0, 0]] * 17
    + [[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 1, 1], [0, 1, 1],
       [1, 1, 1],
       [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 2], [1, 1, 2], [1, 1, 2],
       [1, 1, 2], [1, 2, 3], [1, 2, 3], [2, 2, 3], [2, 2, 4], [2, 3, 4],
       [2, 3, 4], [3, 3, 5], [3, 4, 6], [3, 4, 6], [4, 5, 7], [4, 5, 8],
       [4, 6, 9], [5, 7, 10], [6, 8, 11], [6, 8, 13], [7, 10, 14],
       [8, 11, 16], [9, 12, 18], [10, 13, 20], [11, 15, 23], [13, 17, 25]],
    np.int64,
)


def _edge_filter(plane, y0, x0, n, vertical, bS, idx_a, idx_b, chroma):
    """Filter one deblocking edge of ``n`` lines in-place.  The edge lies
    between column x0-1|x0 (vertical) or row y0-1|y0 (horizontal)."""
    alpha = int(_ALPHA[idx_a])
    beta = int(_BETA[idx_b])
    if alpha == 0:
        return
    if vertical:
        def g(i):
            return plane[y0 : y0 + n, x0 + i].astype(np.int64)

        def s(i, v):
            plane[y0 : y0 + n, x0 + i] = v
    else:
        def g(i):
            return plane[y0 + i, x0 : x0 + n].astype(np.int64)

        def s(i, v):
            plane[y0 + i, x0 : x0 + n] = v

    p0, p1, q0, q1 = g(-1), g(-2), g(0), g(1)
    fm = (
        (np.abs(p0 - q0) < alpha)
        & (np.abs(p1 - p0) < beta)
        & (np.abs(q1 - q0) < beta)
    )
    if not fm.any():
        return
    if not chroma:
        p2, q2 = g(-3), g(2)
        ap = np.abs(p2 - p0) < beta
        aq = np.abs(q2 - q0) < beta

    if bS == 4:  # strong filter (8.7.2.4)
        if chroma:
            s(-1, np.where(fm, (2 * p1 + p0 + q1 + 2) >> 2, p0))
            s(0, np.where(fm, (2 * q1 + q0 + p1 + 2) >> 2, q0))
            return
        p3, q3 = g(-4), g(3)
        small = np.abs(p0 - q0) < ((alpha >> 2) + 2)
        sp = fm & small & ap
        s(-1, np.where(
            sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
            np.where(fm, (2 * p1 + p0 + q1 + 2) >> 2, p0)))
        s(-2, np.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1))
        s(-3, np.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2))
        sq = fm & small & aq
        s(0, np.where(
            sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
            np.where(fm, (2 * q1 + q0 + p1 + 2) >> 2, q0)))
        s(1, np.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1))
        s(2, np.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2))
        return

    # normal filter (8.7.2.3)
    tc0 = int(_TC0[idx_a, bS - 1])
    if chroma:
        tc = tc0 + 1
        delta = np.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
        s(-1, np.where(fm, np.clip(p0 + delta, 0, 255), p0))
        s(0, np.where(fm, np.clip(q0 - delta, 0, 255), q0))
        return
    tc = tc0 + ap.astype(np.int64) + aq.astype(np.int64)
    delta = np.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    s(-1, np.where(fm, np.clip(p0 + delta, 0, 255), p0))
    s(0, np.where(fm, np.clip(q0 - delta, 0, 255), q0))
    dp1 = np.clip((p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1, -tc0, tc0)
    s(-2, np.where(fm & ap, p1 + dp1, p1))
    dq1 = np.clip((q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1, -tc0, tc0)
    s(1, np.where(fm & aq, q1 + dq1, q1))


class _SliceDecoder:
    def __init__(self, sps: _SpsExt, pps: _Pps, dpb: Optional[Dpb] = None):
        self.sps = sps
        self.pps = pps
        self.dpb = dpb
        mbw, mbh = sps.mb_width, sps.mb_height
        self.mbw, self.mbh = mbw, mbh
        self.ry = np.zeros((mbh * 16, mbw * 16), np.int64)
        self.ru = np.zeros((mbh * 8, mbw * 8), np.int64)
        self.rv = np.zeros((mbh * 8, mbw * 8), np.int64)
        self.nnz_y = np.zeros((mbh * 4, mbw * 4), np.int16)
        self.nnz_u = np.zeros((mbh * 2, mbw * 2), np.int16)
        self.nnz_v = np.zeros((mbh * 2, mbw * 2), np.int16)
        # per-MB luma QP (deblocking) and per-4x4 intra mode map
        # (-1 = unavailable; non-I_4x4 MBs record DC=2, spec 8.3.1.1)
        self.qp_map = np.zeros((mbh, mbw), np.int64)
        self.i4_modes = np.full((mbh * 4, mbw * 4), -1, np.int64)
        self.qp_prev = 26
        # inter state (P/B slices): per-4x4-per-list motion field
        # [gy, gx, lx, comp], per-list ref index (-1 = intra/unused),
        # stored-picture identity + POC (deblocking bS, direct modes),
        # and decode-order availability for MV prediction (6.4.9)
        self.slice_type = 2
        self.mv = np.zeros((mbh * 4, mbw * 4, 2, 2), np.int64)
        self.refidx = np.full((mbh * 4, mbw * 4, 2), -1, np.int64)
        self.refpid = np.full((mbh * 4, mbw * 4, 2), -1, np.int64)
        self.refpoc = np.zeros((mbh * 4, mbw * 4, 2), np.int64)
        self.decoded4 = np.zeros((mbh * 4, mbw * 4), bool)
        # ref_idx known before the partition's MV is (CABAC reads all
        # ref_idx of an MB before any mvd, and the ref_idx ctx depends on
        # earlier same-MB partitions' refs, 9.3.3.1.1.6)
        self.refknown = np.zeros((mbh * 4, mbw * 4, 2), bool)
        # cells whose motion is direct-inferred (B): the CABAC ref_idx
        # context ignores such neighbors (9.3.3.1.1.6)
        self.direct4 = np.zeros((mbh * 4, mbw * 4), bool)
        # 8x8-transform MBs (High profile): internal 4x4 edges are not
        # deblocked and bS consults per-8x8 coded flags
        self.t8 = np.zeros((mbh, mbw), bool)
        self.coded8 = np.zeros((mbh * 2, mbw * 2), bool)
        self.mb_intra = np.ones((mbh, mbw), bool)
        self.lists: List[List[RefPic]] = [[], []]
        # explicit WP: (log_wd_y, log_wd_c, [per-list [(wy,oy,wu,ou,wv,ov)]])
        self.wp = None
        self.implicit_wp = False  # B + weighted_bipred_idc == 2
        self.direct_spatial = True
        self.poc = 0
        self.frame_num = 0
        self.is_ref = True
        self.marking_ops: List[Tuple[int, int]] = []
        self.adaptive_marking = False
        self.num_ref_active = [1, 1]
        self.cabac_init_idc = 0
        # within-MB partition-order availability for B MV prediction
        # (6.4.11.7: a same-MB partition later in mbPartIdx/subMbPartIdx
        # order is "not yet decoded"; direct-inferred blocks are always
        # available, matching decoder-cache semantics)
        self._bcur = None  # (mx, my) while a B MB's motion parses
        self._bord = np.full((4, 4), 99, np.int64)
        self._bk = 99

    @property
    def list0(self) -> List[RefPic]:
        return self.lists[0]

    @property
    def list1(self) -> List[RefPic]:
        return self.lists[1]

    def _nC(self, nnz, mx, my, bx, by, grid) -> int:
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

    def _compute_poc(self, r: BitReader, nal_unit_type: int) -> Optional[int]:
        """PicOrderCnt of the current (frame) picture (spec 8.2.1),
        consuming the slice header's POC syntax; ``None`` when the POC
        type is outside this decoder's scope (only B prediction ever
        consults it)."""
        sps, dpb = self.sps, self.dpb
        if sps.poc_type == 0:
            lsb = r.bits(sps.log2_max_poc_lsb)
            if self.pps.bottom_field_poc:
                r.se()  # delta_pic_order_cnt_bottom (frame coding: unused)
            if dpb is None:
                return None
            if nal_unit_type == 5:
                dpb.prev_poc_msb = dpb.prev_poc_lsb = 0
            max_lsb = 1 << sps.log2_max_poc_lsb
            if (lsb < dpb.prev_poc_lsb
                    and dpb.prev_poc_lsb - lsb >= max_lsb // 2):
                msb = dpb.prev_poc_msb + max_lsb
            elif (lsb > dpb.prev_poc_lsb
                    and lsb - dpb.prev_poc_lsb > max_lsb // 2):
                msb = dpb.prev_poc_msb - max_lsb
            else:
                msb = dpb.prev_poc_msb
            if self.is_ref:
                dpb.prev_poc_msb, dpb.prev_poc_lsb = msb, lsb
            return msb + lsb
        if sps.poc_type == 1:
            if not sps.delta_poc_always_zero:
                r.se()
                if self.pps.bottom_field_poc:
                    r.se()
            return None  # full type-1 POC: no encoder in scope emits it
        # poc_type 2 (8.2.1.3): output order == decode order
        if dpb is None:
            return None
        if nal_unit_type == 5:
            fno = 0
        elif dpb.prev_frame_num > self.frame_num:
            fno = dpb.prev_fno + (1 << sps.log2_max_frame_num)
        else:
            fno = dpb.prev_fno
        dpb.prev_fno, dpb.prev_frame_num = fno, self.frame_num
        return 2 * (fno + self.frame_num) - (0 if self.is_ref else 1)

    def _check_ref_shapes(self):
        """Every reference of the lists has the active SPS's plane (and,
        when stored, motion-grid) shapes.  A picture of other dimensions
        raises here, before any tier indexes its planes (the native inter
        tier would read past them)."""
        ys, cs = (self.mbh * 16, self.mbw * 16), (self.mbh * 8, self.mbw * 8)
        for lst in self.lists:
            for p in lst:
                if p is None:
                    continue
                if (p.y.shape != ys or p.u.shape != cs or p.v.shape != cs
                        or (p.mv is not None
                            and p.mv.shape[:2] != (self.mbh * 4, self.mbw * 4))):
                    raise H264DecodeError(
                        f"reference picture of {p.y.shape[1]}x{p.y.shape[0]} "
                        f"in a slice of {ys[1]}x{ys[0]}")

    def _parse_ref_list_modification(self, r: BitReader, lst, num_active):
        """ref_pic_list_modification for one list (7.3.3.1 / 8.2.4.3.1):
        a fixed working array of num_active+1 slots, exactly the spec's
        shift-insert-compact process (x264 weightp=2 uses this to
        duplicate a reference with different weights)."""
        max_fn = 1 << self.sps.log2_max_frame_num
        arr = (list(lst) + [None] * (num_active + 1))[:num_active + 1]
        ref_idx = 0
        pic_num_pred = self.frame_num
        while True:
            idc = r.ue()
            if idc == 3:
                break
            if idc > 3:
                raise H264DecodeError(
                    f"bad ref list modification idc {idc}")
            if idc == 2:
                raise H264Unsupported(
                    "long-term references unsupported")
            diff = r.ue() + 1
            no_wrap = (pic_num_pred - diff if idc == 0
                       else pic_num_pred + diff)
            no_wrap = (no_wrap + max_fn) % max_fn
            pic_num_pred = no_wrap
            pic_num = (no_wrap if no_wrap <= self.frame_num
                       else no_wrap - max_fn)
            pic = next(
                (p for p in self.dpb.pics
                 if Dpb._pic_num(p, self.frame_num, max_fn)
                 == pic_num), None)
            if pic is None:
                raise H264DecodeError(
                    f"ref list modification: no pic_num {pic_num}")
            if ref_idx > num_active:
                raise H264DecodeError(
                    "ref list modification overruns the list")
            arr[ref_idx + 1:] = arr[ref_idx:-1]
            arr[ref_idx] = pic
            ref_idx += 1
            n_idx = ref_idx
            for c_idx in range(ref_idx, num_active + 1):
                if arr[c_idx] is not pic:
                    arr[n_idx] = arr[c_idx]
                    n_idx += 1
            for k in range(n_idx, num_active + 1):
                arr[k] = None
        return arr

    def _parse_weight_entries(self, r: BitReader, num_active: int,
                              log_y: int, log_c: int):
        entries = []
        for _ in range(num_active):
            wy, oy = 1 << log_y, 0
            wu = wv = 1 << log_c
            ou = ov = 0
            if r.bit():
                wy, oy = r.se(), r.se()
            if r.bit():
                wu, ou = r.se(), r.se()
                wv, ov = r.se(), r.se()
            entries.append((wy, oy, wu, ou, wv, ov))
        return entries

    def _parse_slice_header(self, r: BitReader, nal_unit_type: int,
                            nal_ref_idc: int = 1):
        """Slice header shared by the CAVLC and CABAC tiers (spec 7.3.3),
        I/P/B slices; returns (first_mb, qp, disable_idc, off_a, off_b),
        seeds the mb_qp_delta chain, and stashes the inter slice state
        (slice_type, lists, POC, weights, marking ops, cabac_init_idc)
        on self."""
        sps, pps = self.sps, self.pps
        first_mb = r.ue()
        if first_mb != 0:
            # intra-pred availability would need slice-boundary tracking
            raise H264DecodeError("multi-slice pictures unsupported")
        slice_type = r.ue() % 5
        if slice_type not in (0, 1, 2):
            raise H264Unsupported(
                f"slice type {slice_type} unsupported (I/P/B only)")
        self.slice_type = slice_type
        is_p = slice_type == 0
        is_b = slice_type == 1
        r.ue()  # pps id (single-PPS streams)
        self.frame_num = r.bits(sps.log2_max_frame_num)
        self.is_ref = nal_ref_idc != 0
        if nal_unit_type == 5:
            r.ue()  # idr_pic_id
        poc = self._compute_poc(r, nal_unit_type)
        self.poc = poc
        if pps.redundant_pic_cnt_present and r.ue() != 0:
            raise H264Unsupported("redundant pictures unsupported")
        if is_b:
            self.direct_spatial = bool(r.bit())
        num_active = [pps.num_ref_idx_l0, pps.num_ref_idx_l1]
        if is_p or is_b:
            if pps.constrained_intra_pred:
                raise H264Unsupported(
                    "constrained_intra_pred inter slices unsupported")
            if self.dpb is None:
                raise H264Unsupported("inter slice without reference buffer")
            if r.bit():  # num_ref_idx_active_override_flag
                num_active[0] = r.ue() + 1
                if is_b:
                    num_active[1] = r.ue() + 1
            if max(num_active) > 16:
                raise H264DecodeError("num_ref_idx_active > 16")
            max_fn = 1 << sps.log2_max_frame_num
            if is_b:
                if poc is None:
                    raise H264Unsupported(
                        "B slices need a supported pic_order_cnt_type")
                init = self.dpb.init_lists_b(poc)
            else:
                init = (self.dpb.init_list_p(self.frame_num, max_fn),)
            for lx, lst in enumerate(init):
                if r.bit():  # ref_pic_list_modification_flag_lX
                    lst = self._parse_ref_list_modification(
                        r, lst, num_active[lx])
                self.lists[lx] = list(lst)[:num_active[lx]]
                while self.lists[lx] and self.lists[lx][-1] is None:
                    self.lists[lx].pop()
                if not self.lists[lx]:
                    raise H264DecodeError(
                        "inter slice with an empty reference list")
            self._check_ref_shapes()
            self.num_ref_active = num_active
            # pred_weight_table (7.3.3.2): explicit WP for P, explicit
            # bipred (idc 1) for B; implicit bipred (idc 2) derives the
            # weights from POC distances per prediction pair (8.4.2.3.1)
            self.wp = None
            self.implicit_wp = is_b and pps.weighted_bipred_idc == 2
            if self.implicit_wp and poc is None:
                raise H264Unsupported(
                    "implicit weighted bipred needs a supported POC type")
            if (pps.weighted_pred and is_p) or (
                    is_b and pps.weighted_bipred_idc == 1):
                log_y = r.ue()
                log_c = r.ue()
                if log_y > 7 or log_c > 7:
                    raise H264DecodeError("bad luma/chroma weight denom")
                per_list = [self._parse_weight_entries(
                    r, num_active[0], log_y, log_c)]
                if is_b:
                    per_list.append(self._parse_weight_entries(
                        r, num_active[1], log_y, log_c))
                self.wp = (log_y, log_c, per_list)
        self.marking_ops = []
        if nal_unit_type == 5:
            r.bit()  # no_output_of_prior_pics
            if r.bit():  # long_term_reference_flag
                raise H264Unsupported("long-term references unsupported")
        elif nal_ref_idc != 0:
            if r.bit():  # adaptive_ref_pic_marking_mode_flag
                self.adaptive_marking = True
                while True:
                    op = r.ue()
                    if op == 0:
                        break
                    if op == 1:
                        self.marking_ops.append((1, r.ue() + 1))
                    else:
                        raise H264Unsupported(
                            f"memory management control op {op} unsupported")
        if pps.entropy_cabac and (is_p or is_b):
            self.cabac_init_idc = r.ue()
            if self.cabac_init_idc > 2:
                raise H264DecodeError("bad cabac_init_idc")
        qp = pps.pic_init_qp + r.se()
        self.qp_prev = qp
        disable_idc = 0
        off_a = off_b = 0
        if pps.deblocking_control:
            disable_idc = r.ue()
            if disable_idc > 2:
                raise H264DecodeError("bad disable_deblocking_filter_idc")
            if disable_idc != 1:
                off_a = 2 * r.se()  # slice_alpha_c0_offset_div2
                off_b = 2 * r.se()  # slice_beta_offset_div2
        # idc 2 (don't cross slice boundaries) == idc 0 for our
        # single-slice pictures
        return first_mb, qp, disable_idc, off_a, off_b

    def decode_slice(self, r: BitReader, nal_unit_type: int,
                     nal_ref_idc: int = 1):
        first_mb, _qp, disable_idc, off_a, off_b = self._parse_slice_header(
            r, nal_unit_type, nal_ref_idc)
        mb_addr = first_mb
        n_mbs = self.mbw * self.mbh
        if self.slice_type in (0, 1):  # P/B slice data (7.3.4)
            skip = (self._p_skip_mb if self.slice_type == 0
                    else self._b_skip_mb)
            mb = (self._decode_mb_p if self.slice_type == 0
                  else self._decode_mb_b)
            while mb_addr < n_mbs and r.more_rbsp_data():
                skip_run = r.ue()
                if mb_addr + skip_run > n_mbs:
                    raise H264DecodeError("mb_skip_run overruns the picture")
                for _ in range(skip_run):
                    skip(mb_addr % self.mbw, mb_addr // self.mbw)
                    mb_addr += 1
                if mb_addr < n_mbs and r.more_rbsp_data():
                    mb(r, mb_addr % self.mbw, mb_addr // self.mbw)
                    mb_addr += 1
        else:
            while mb_addr < n_mbs and r.more_rbsp_data():
                self._decode_mb(r, mb_addr % self.mbw, mb_addr // self.mbw)
                mb_addr += 1
        if mb_addr != n_mbs:
            raise H264DecodeError(
                f"slice ended after {mb_addr}/{n_mbs} macroblocks"
            )
        if disable_idc != 1:
            if self.slice_type in (0, 1) or self.t8.any():
                self._deblock_general(off_a, off_b)
            else:
                self._deblock(off_a, off_b)

    def _qpc(self, qp: int, comp: int) -> int:
        off = (self.pps.chroma_qp_offset if comp == 0
               else self.pps.chroma_qp_offset2)
        qpc_i = int(np.clip(qp + off, 0, 51))
        return qpc_i if qpc_i < 30 else _QPC[qpc_i - 30]

    def _decode_mb(self, r: BitReader, mx: int, my: int):
        self._decode_mb_intra(r, mx, my, r.ue())

    # ---- P macroblocks (spec 7.3.5, 8.4) --------------------------------

    def _mark_inter(self, mx: int, my: int):
        self.mb_intra[my, mx] = False
        # inter neighbors present DC mode to I_4x4 prediction (8.3.1.1,
        # constrained_intra_pred_flag == 0)
        self.i4_modes[my * 4: my * 4 + 4, mx * 4: mx * 4 + 4] = 2

    def _read_ref_idx(self, r: BitReader, lx: int = 0) -> int:
        lst = self.lists[lx]
        n = len(lst)
        cmax = self.num_ref_active[lx] - 1
        if cmax == 0:
            idx = 0
        elif cmax == 1:
            idx = 1 - r.bit()  # te(v), cMax 1 (9.1.1)
        else:
            idx = r.ue()
        if idx >= n or lst[idx] is None:
            raise H264DecodeError(f"ref_idx {idx} outside the {n}-entry "
                                  "reference list")
        return idx

    def _p_skip_mb(self, mx: int, my: int):
        """P_Skip (7.4.4, 8.4.1.1): 16x16 MC at the inferred motion
        vector, refIdx 0, no residual."""
        self._mark_inter(mx, my)
        gx, gy = mx * 4, my * 4
        a_ref, a_x, a_y = self._nbinfo(gx - 1, gy)
        b_ref, b_x, b_y = self._nbinfo(gx, gy - 1)
        if (a_ref == -2 or b_ref == -2
                or (a_ref == 0 and a_x == 0 and a_y == 0)
                or (b_ref == 0 and b_x == 0 and b_y == 0)):
            mvx = mvy = 0
        else:
            mvx, mvy = self._mvp(gx, gy, 4, 4, 0, None)
        self._set_part(mx, my, 0, 0, 16, 16, 0, mvx, mvy)
        py, pu, pv = self._inter_pred_mb(
            mx, my, [(0, 0, 16, 16, (0, -1), ((mvx, mvy), (0, 0)))])
        y0, x0 = my * 16, mx * 16
        self.ry[y0: y0 + 16, x0: x0 + 16] = py
        self.ru[my * 8: my * 8 + 8, mx * 8: mx * 8 + 8] = pu
        self.rv[my * 8: my * 8 + 8, mx * 8: mx * 8 + 8] = pv
        self.nnz_y[my * 4: my * 4 + 4, mx * 4: mx * 4 + 4] = 0
        self.nnz_u[my * 2: my * 2 + 2, mx * 2: mx * 2 + 2] = 0
        self.nnz_v[my * 2: my * 2 + 2, mx * 2: mx * 2 + 2] = 0
        self.qp_map[my, mx] = self.qp_prev  # QPy unchanged (7.4.4)

    def _decode_mb_p(self, r: BitReader, mx: int, my: int):
        mb_type = r.ue()
        if mb_type >= 5:  # intra MB in a P slice (Table 7-13)
            self.decoded4[my * 4: my * 4 + 4, mx * 4: mx * 4 + 4] = True
            self._decode_mb_intra(r, mx, my, mb_type - 5)
            return
        self._mark_inter(mx, my)
        allow8 = True  # 8x8 transform needs all partitions >= 8x8
        parts: List[Tuple[int, int, int, int, int, int, int]] = []
        if mb_type in (0, 1, 2):
            shapes = _P_PARTS[mb_type]
            refs = [self._read_ref_idx(r) for _ in shapes]
            mvds = [(r.se(), r.se()) for _ in shapes]
            hint = {0: (None,), 1: ("16x8_top", "16x8_bot"),
                    2: ("8x16_left", "8x16_right")}[mb_type]
            for (px, py_, w, h), ref, (dx, dy), hn in zip(
                    shapes, refs, mvds, hint):
                gx, gy = mx * 4 + px // 4, my * 4 + py_ // 4
                px_x, px_y = self._mvp(gx, gy, w // 4, h // 4, ref, hn)
                mvx, mvy = px_x + dx, px_y + dy
                self._set_part(mx, my, px, py_, w, h, ref, mvx, mvy)
                parts.append((px, py_, w, h, (ref, -1),
                              ((mvx, mvy), (0, 0))))
        else:  # P_8x8 / P_8x8ref0 (7.3.5.2)
            if mb_type > 4:
                raise H264DecodeError(f"bad P mb_type {mb_type}")
            subs = []
            for _ in range(4):
                st = r.ue()
                if st > 3:
                    raise H264DecodeError(f"bad P sub_mb_type {st}")
                subs.append(st)
            allow8 = all(st == 0 for st in subs)
            if mb_type == 3:
                refs = [self._read_ref_idx(r) for _ in range(4)]
            else:
                refs = [0, 0, 0, 0]
                if not self.list0 or self.list0[0] is None:
                    raise H264DecodeError("P_8x8ref0 with an empty list")
            mvds = [[(r.se(), r.se()) for _ in _P_SUB_PARTS[st]]
                    for st in subs]
            for b8 in range(4):
                bx0, by0 = (b8 % 2) * 8, (b8 // 2) * 8
                ref = refs[b8]
                for (sx, sy, w, h), (dx, dy) in zip(
                        _P_SUB_PARTS[subs[b8]], mvds[b8]):
                    px, py_ = bx0 + sx, by0 + sy
                    gx, gy = mx * 4 + px // 4, my * 4 + py_ // 4
                    px_x, px_y = self._mvp(gx, gy, w // 4, h // 4, ref, None)
                    mvx, mvy = px_x + dx, px_y + dy
                    self._set_part(mx, my, px, py_, w, h, ref, mvx, mvy)
                    parts.append((px, py_, w, h, (ref, -1),
                                  ((mvx, mvy), (0, 0))))
        pred_y, pred_u, pred_v = self._inter_pred_mb(mx, my, parts)

        cbp_code = r.ue()
        if cbp_code >= len(_CBP_INTER):
            raise H264DecodeError("bad coded_block_pattern")
        cbp = _CBP_INTER[cbp_code]
        self._finish_inter_residual_cavlc(r, mx, my, cbp,
                                          pred_y, pred_u, pred_v, allow8)

    # ---- B macroblocks (spec 7.3.5, 8.4.1.2) -----------------------------

    def _direct_refs_spatial(self):
        """MB-level spatial-direct reference indices and MV predictors
        (8.4.1.2.2): derived once per MB from the 16x16 neighbors."""
        gx0, gy0 = self._dgx0, self._dgy0
        refs = []
        for lx in (0, 1):
            a = self._nbinfo(gx0 - 1, gy0, lx)
            b = self._nbinfo(gx0, gy0 - 1, lx)
            c = self._nbinfo(gx0 + 4, gy0 - 1, lx)
            if c[0] == -2:
                c = self._nbinfo(gx0 - 1, gy0 - 1, lx)
            pos = [n[0] for n in (a, b, c) if n[0] >= 0]
            refs.append(min(pos) if pos else -1)
        r0, r1 = refs
        if r0 < 0 and r1 < 0:  # directZeroPredictionFlag
            return (0, 0), ((0, 0), (0, 0)), True
        for lx, ref in ((0, r0), (1, r1)):
            if ref >= len(self.lists[lx]) or (
                    ref >= 0 and self.lists[lx][ref] is None):
                raise H264DecodeError(
                    "spatial direct ref outside the reference list")
        mvps = tuple(
            self._mvp(gx0, gy0, 4, 4, ref, None, lx) if ref >= 0 else (0, 0)
            for lx, ref in ((0, r0), (1, r1)))
        return (r0, r1), mvps, False

    def _direct_parts(self, mx: int, my: int, blocks=(0, 1, 2, 3)):
        """Derived motion for B_Skip / B_Direct_16x16 / B_Direct_8x8
        (8.4.1.2, direct_8x8_inference coding): the part list for the
        given 8x8 block indices, with the per-list motion state set.
        Consults the co-located motion of RefPicList1[0]."""
        col = self.lists[1][0]
        if col.mv is None and not col.intra_only:
            raise H264Unsupported(
                "B direct prediction from a reference picture decoded "
                "without exported motion")
        if not self.sps.direct_8x8_inference:
            raise H264Unsupported(
                "direct_8x8_inference_flag == 0 unsupported")

        def col_cell(ccy, ccx):
            """(list, refIdxCol, mvx, mvy) of the co-located 4x4 cell;
            refIdxCol -1 when it is intra-coded (8.4.1.2.2)."""
            if col.intra_only:
                return 0, -1, 0, 0
            cref = int(col.refidx[ccy, ccx, 0])
            clx = 0
            if cref < 0:
                cref = int(col.refidx[ccy, ccx, 1])
                clx = 1
            if cref < 0:
                return clx, -1, 0, 0
            return (clx, cref, int(col.mv[ccy, ccx, clx, 0]),
                    int(col.mv[ccy, ccx, clx, 1]))
        gx0, gy0 = mx * 4, my * 4
        self._dgx0, self._dgy0 = gx0, gy0
        parts = []
        if self.direct_spatial:
            (r0, r1), mvps, zero_pred = self._direct_refs_spatial()
            for b8 in blocks:
                bx0, by0 = (b8 & 1) * 8, (b8 >> 1) * 8
                ccx, ccy = gx0 + 3 * (b8 & 1), gy0 + 3 * (b8 >> 1)
                colzero = False
                if not zero_pred:
                    _clx, cref, cmx, cmy = col_cell(ccy, ccx)
                    if cref == 0:
                        colzero = -1 <= cmx <= 1 and -1 <= cmy <= 1
                mvs = []
                for lx, ref in ((0, r0), (1, r1)):
                    if ref < 0:
                        mvs.append((0, 0))
                    elif zero_pred or (ref == 0 and colzero):
                        mvs.append((0, 0))
                    else:
                        mvs.append(mvps[lx])
                for lx, ref in ((0, r0), (1, r1)):
                    if ref >= 0:
                        self._set_part(mx, my, bx0, by0, 8, 8, ref,
                                       *mvs[lx], lx)
                gx, gy = gx0 + bx0 // 4, gy0 + by0 // 4
                self.direct4[gy: gy + 2, gx: gx + 2] = True
                parts.append((bx0, by0, 8, 8, (r0, r1), tuple(mvs)))
            return parts
        # temporal direct (8.4.1.2.3)
        for b8 in blocks:
            bx0, by0 = (b8 & 1) * 8, (b8 >> 1) * 8
            ccx, ccy = gx0 + 3 * (b8 & 1), gy0 + 3 * (b8 >> 1)
            clx, cref, cmx, cmy = col_cell(ccy, ccx)
            if cref < 0:  # co-located block intra: mvCol = 0, refIdx 0
                r0 = 0
                mv0 = mv1 = (0, 0)
            else:
                colpid = int(col.refpid[ccy, ccx, clx])
                colpoc = int(col.refpoc[ccy, ccx, clx])
                r0 = next(
                    (i for i, p in enumerate(self.lists[0])
                     if p is not None and p.pid == colpid), None)
                if r0 is None:
                    raise H264DecodeError(
                        "temporal direct: co-located reference picture "
                        "not in the current list0")
                td = min(max(col.poc - colpoc, -128), 127)
                if td == 0:
                    mv0 = (cmx, cmy)
                    mv1 = (0, 0)
                else:
                    tb = min(max(self.poc - colpoc, -128), 127)
                    num = 16384 + abs(td) // 2
                    tx = num // td if td > 0 else -(num // -td)
                    dsf = min(max((tb * tx + 32) >> 6, -1024), 1023)
                    mv0 = ((dsf * cmx + 128) >> 8, (dsf * cmy + 128) >> 8)
                    mv1 = (mv0[0] - cmx, mv0[1] - cmy)
            if not self.lists[0] or self.lists[0][r0] is None:
                raise H264DecodeError("temporal direct ref outside list0")
            self._set_part(mx, my, bx0, by0, 8, 8, r0, *mv0, 0)
            self._set_part(mx, my, bx0, by0, 8, 8, 0, *mv1, 1)
            gx, gy = gx0 + bx0 // 4, gy0 + by0 // 4
            self.direct4[gy: gy + 2, gx: gx + 2] = True
            parts.append((bx0, by0, 8, 8, (r0, 0), (mv0, mv1)))
        return parts

    def _b_skip_mb(self, mx: int, my: int):
        """B_Skip (7.4.4): direct prediction, no residual."""
        self._mark_inter(mx, my)
        parts = self._direct_parts(mx, my)
        py, pu, pv = self._inter_pred_mb(mx, my, parts)
        y0, x0 = my * 16, mx * 16
        self.ry[y0: y0 + 16, x0: x0 + 16] = py
        self.ru[my * 8: my * 8 + 8, mx * 8: mx * 8 + 8] = pu
        self.rv[my * 8: my * 8 + 8, mx * 8: mx * 8 + 8] = pv
        self.nnz_y[my * 4: my * 4 + 4, mx * 4: mx * 4 + 4] = 0
        self.nnz_u[my * 2: my * 2 + 2, mx * 2: mx * 2 + 2] = 0
        self.nnz_v[my * 2: my * 2 + 2, mx * 2: mx * 2 + 2] = 0
        self.qp_map[my, mx] = self.qp_prev  # QPy unchanged (7.4.4)

    def _decode_mb_b(self, r: BitReader, mx: int, my: int):
        mb_type = r.ue()
        if mb_type >= 23:  # intra MB in a B slice (Table 7-14)
            self.decoded4[my * 4: my * 4 + 4, mx * 4: mx * 4 + 4] = True
            self._decode_mb_intra(r, mx, my, mb_type - 23)
            return
        self._mark_inter(mx, my)
        parts, allow8 = self._parse_b_motion(
            r, mx, my, mb_type,
            lambda gx, gy, w, h, lx: self._read_ref_idx(r, lx),
            lambda gx, gy, comp, lx: r.se())
        pred_y, pred_u, pred_v = self._inter_pred_mb(mx, my, parts)

        cbp_code = r.ue()
        if cbp_code >= len(_CBP_INTER):
            raise H264DecodeError("bad coded_block_pattern")
        cbp = _CBP_INTER[cbp_code]
        self._finish_inter_residual_cavlc(r, mx, my, cbp,
                                          pred_y, pred_u, pred_v, allow8)

    def _parse_b_motion(self, r, mx: int, my: int, mb_type: int,
                        read_ref, read_mvd):
        """B macroblock prediction parse (7.3.5.1/7.3.5.2, Tables
        7-14/7-18), shared by the CAVLC and CABAC tiers via the
        ``read_ref(lx)`` / ``read_mvd(gx, gy, comp, lx)`` callbacks:
        all ref_idx_l0, then ref_idx_l1, then mvd_l0, then mvd_l1;
        returns (parts, allow_8x8_transform) with the motion state
        set."""
        if mb_type == 0:  # B_Direct_16x16
            # direct_8x8_inference (required in scope) keeps every
            # inferred partition >= 8x8 (7.3.5 transform flag condition)
            return self._direct_parts(mx, my), True
        if mb_type != 22:
            shape_key, masks = _B_MODES[mb_type]
            shapes = _P_PARTS[shape_key]
            hints = {0: (None,), 1: ("16x8_top", "16x8_bot"),
                     2: ("8x16_left", "8x16_right")}[shape_key]
            refs = [[-1, -1] for _ in shapes]
            for lx in (0, 1):
                for i, mask in enumerate(masks):
                    if mask & (1 << lx):
                        px, py_, w, h = shapes[i]
                        gx, gy = mx * 4 + px // 4, my * 4 + py_ // 4
                        refs[i][lx] = read_ref(gx, gy, w, h, lx)
            mvs = [[(0, 0), (0, 0)] for _ in shapes]
            parts = []
            self._bord.fill(99)
            for i, (px, py_, w, h) in enumerate(shapes):
                self._bord[py_ // 4: (py_ + h) // 4,
                           px // 4: (px + w) // 4] = i
            self._bcur = (mx, my)
            for lx in (0, 1):
                for i, mask in enumerate(masks):
                    if not mask & (1 << lx):
                        continue
                    px, py_, w, h = shapes[i]
                    gx, gy = mx * 4 + px // 4, my * 4 + py_ // 4
                    dx = read_mvd(gx, gy, 0, lx)
                    dy = read_mvd(gx, gy, 1, lx)
                    self._bk = i
                    px_x, px_y = self._mvp(gx, gy, w // 4, h // 4,
                                           refs[i][lx], hints[i], lx)
                    mvs[i][lx] = (px_x + dx, px_y + dy)
                    self._set_part(mx, my, px, py_, w, h, refs[i][lx],
                                   px_x + dx, px_y + dy, lx)
                    self._note_absmvd(gx, gy, w // 4, h // 4, dx, dy, lx)
            self._bcur = None
            for i, (px, py_, w, h) in enumerate(shapes):
                parts.append((px, py_, w, h, tuple(refs[i]),
                              tuple(mvs[i])))
            return parts, True
        # B_8x8 (7.3.5.2, Table 7-18)
        subs = [self._read_b_sub_type(r) for _ in range(4)]
        for st in subs:
            if st > 12:
                raise H264DecodeError(f"bad B sub_mb_type {st}")
        # direct 8x8 blocks derive their motion before any neighbor
        # within this MB consults them for MV prediction
        direct_parts = {}
        direct_blocks = [b8 for b8 in range(4) if subs[b8] == 0]
        if direct_blocks:
            for b8, part in zip(direct_blocks,
                                self._direct_parts(mx, my, direct_blocks)):
                direct_parts[b8] = part
        refs = [[-1, -1] for _ in range(4)]
        for lx in (0, 1):
            for b8 in range(4):
                if subs[b8] == 0:
                    continue
                _shape, mask = _B_SUB[subs[b8]]
                if mask & (1 << lx):
                    bx0, by0 = (b8 & 1) * 8, (b8 >> 1) * 8
                    gx, gy = mx * 4 + bx0 // 4, my * 4 + by0 // 4
                    refs[b8][lx] = read_ref(gx, gy, 8, 8, lx)
        sub_mvs = {}
        self._bord.fill(99)
        for b8 in range(4):
            bx0, by0 = (b8 & 1) * 2, (b8 >> 1) * 2
            if subs[b8] == 0:  # direct: available to every partition
                self._bord[by0: by0 + 2, bx0: bx0 + 2] = -1
                continue
            shape_key = _B_SUB[subs[b8]][0]
            for si, (sx, sy, w, h) in enumerate(_P_SUB_PARTS[shape_key]):
                self._bord[by0 + sy // 4: by0 + (sy + h) // 4,
                           bx0 + sx // 4: bx0 + (sx + w) // 4] = \
                    b8 * 4 + si
        self._bcur = (mx, my)
        for lx in (0, 1):
            for b8 in range(4):
                if subs[b8] == 0:
                    continue
                shape_key, mask = _B_SUB[subs[b8]]
                if not mask & (1 << lx):
                    continue
                bx0, by0 = (b8 & 1) * 8, (b8 >> 1) * 8
                for si, (sx, sy, w, h) in enumerate(
                        _P_SUB_PARTS[shape_key]):
                    px, py_ = bx0 + sx, by0 + sy
                    gx, gy = mx * 4 + px // 4, my * 4 + py_ // 4
                    dx = read_mvd(gx, gy, 0, lx)
                    dy = read_mvd(gx, gy, 1, lx)
                    self._bk = b8 * 4 + si
                    px_x, px_y = self._mvp(gx, gy, w // 4, h // 4,
                                           refs[b8][lx], None, lx)
                    self._set_part(mx, my, px, py_, w, h, refs[b8][lx],
                                   px_x + dx, px_y + dy, lx)
                    self._note_absmvd(gx, gy, w // 4, h // 4, dx, dy, lx)
                    sub_mvs[(b8, si, lx)] = (px_x + dx, px_y + dy)
        self._bcur = None
        parts = []
        for b8 in range(4):
            if subs[b8] == 0:
                parts.append(direct_parts[b8])
                continue
            shape_key, mask = _B_SUB[subs[b8]]
            bx0, by0 = (b8 & 1) * 8, (b8 >> 1) * 8
            for si, (sx, sy, w, h) in enumerate(_P_SUB_PARTS[shape_key]):
                mvs = [(0, 0), (0, 0)]
                prefs = [-1, -1]
                for lx in (0, 1):
                    if mask & (1 << lx):
                        prefs[lx] = refs[b8][lx]
                        mvs[lx] = sub_mvs[(b8, si, lx)]
                parts.append((bx0 + sx, by0 + sy, w, h,
                              tuple(prefs), tuple(mvs)))
        return parts, all(st <= 3 for st in subs)

    def _read_b_sub_type(self, r: BitReader) -> int:
        return r.ue()

    def _note_absmvd(self, gx, gy, w4, h4, dx, dy, lx):
        """|mvd| bookkeeping hook: a no-op for CAVLC; the CABAC subclass
        records it for the mvd context (9.3.3.1.1.7)."""

    def _finish_inter_residual_cavlc(self, r, mx, my, cbp,
                                     pred_y, pred_u, pred_v,
                                     allow8=False):
        """Shared P/B CAVLC inter-MB residual + reconstruction tail;
        transform_size_8x8_flag sits between coded_block_pattern and
        mb_qp_delta (7.3.5)."""
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        t8 = False
        if cbp_luma and allow8 and self.pps.transform_8x8:
            t8 = bool(r.bit())
            self.t8[my, mx] = t8
        if cbp:
            qp = (self.qp_prev + r.se() + 52) % 52
            self.qp_prev = qp
        else:
            qp = self.qp_prev
        self.qp_map[my, mx] = qp
        if t8:
            Z8 = self._read_luma8_cavlc(r, mx, my, cbp_luma)
            CZD, CZA = self._read_chroma(r, mx, my, cbp_chroma)
            self._recon_inter_mb8(mx, my, qp, Z8, CZD, CZA,
                                  pred_y, pred_u, pred_v)
            return

        gy0, gx0 = my * 4, mx * 4
        self.nnz_y[gy0: gy0 + 4, gx0: gx0 + 4] = 0
        Z = np.zeros((16, 4, 4), np.int64)
        for i, (bx, by) in enumerate(_BLK_POS):
            if not (cbp_luma >> (i >> 2)) & 1:
                continue
            nC = self._nC(self.nnz_y, mx, my, bx, by, 4)
            scan = read_cavlc_block(r, nC, 16)
            flat = np.zeros(16, np.int64)
            for k, z in enumerate(ZIGZAG):
                flat[z] = scan[k]
            Z[i] = flat.reshape(4, 4)
            self.nnz_y[gy0 + by, gx0 + bx] = int(np.count_nonzero(scan))
        CZD, CZA = self._read_chroma(r, mx, my, cbp_chroma)
        self._recon_inter_mb(mx, my, qp, Z, CZD, CZA,
                             pred_y, pred_u, pred_v)

    # ---- motion vector prediction (spec 8.4.1.3) ------------------------

    def _nbinfo(self, cx: int, cy: int, lx: int = 0) -> Tuple[int, int, int]:
        """(refIdx, mvx, mvy) of the 4x4 cell (cx, cy) for list ``lx``:
        refIdx -2 when the location is unavailable (outside the picture or
        not yet decoded, 6.4.9), -1 when the cell is intra-coded or does
        not predict from list lx (8.4.1.3.2: mv 0)."""
        if cx < 0 or cy < 0 or cx >= self.mbw * 4 or cy >= self.mbh * 4:
            return -2, 0, 0
        if self._bcur is not None:
            bmx, bmy = self._bcur
            ly, lxc = cy - bmy * 4, cx - bmx * 4
            if 0 <= ly < 4 and 0 <= lxc < 4:
                # same-MB cell: partition order governs availability
                if self._bord[ly, lxc] > self._bk:
                    return -2, 0, 0
                ref = int(self.refidx[cy, cx, lx])
                if ref < 0:
                    return -1, 0, 0
                return (ref, int(self.mv[cy, cx, lx, 0]),
                        int(self.mv[cy, cx, lx, 1]))
        if not self.decoded4[cy, cx]:
            return -2, 0, 0
        ref = int(self.refidx[cy, cx, lx])
        if ref < 0:
            return -1, 0, 0
        return ref, int(self.mv[cy, cx, lx, 0]), int(self.mv[cy, cx, lx, 1])

    def _mvp(self, gx: int, gy: int, w4: int, h4: int, ref: int,
             hint: Optional[str], lx: int = 0) -> Tuple[int, int]:
        """Median motion vector prediction with the 16x8/8x16 directional
        shortcuts (8.4.1.3); (gx, gy) in 4x4-grid units."""
        a = self._nbinfo(gx - 1, gy, lx)
        b = self._nbinfo(gx, gy - 1, lx)
        c = self._nbinfo(gx + w4, gy - 1, lx)
        if c[0] == -2:
            c = self._nbinfo(gx - 1, gy - 1, lx)  # D substitution (8.4.1.3.2)
        if hint == "16x8_top" and b[0] == ref:
            return b[1], b[2]
        if hint in ("16x8_bot", "8x16_left") and a[0] == ref:
            return a[1], a[2]
        if hint == "8x16_right" and c[0] == ref:
            return c[1], c[2]
        match = [n for n in (a, b, c) if n[0] == ref]
        if len(match) == 1:
            return match[0][1], match[0][2]
        if b[0] == -2 and c[0] == -2 and a[0] != -2:
            return a[1], a[2]
        return (_median3(a[1], b[1], c[1]), _median3(a[2], b[2], c[2]))

    def _set_part(self, mx: int, my: int, px: int, py: int, w: int, h: int,
                  ref: int, mvx: int, mvy: int, lx: int = 0):
        gx, gy = mx * 4 + px // 4, my * 4 + py // 4
        w4, h4 = w // 4, h // 4
        self.mv[gy: gy + h4, gx: gx + w4, lx] = (mvx, mvy)
        self.refidx[gy: gy + h4, gx: gx + w4, lx] = ref
        pic = self.lists[lx][ref]
        self.refpid[gy: gy + h4, gx: gx + w4, lx] = pic.pid
        self.refpoc[gy: gy + h4, gx: gx + w4, lx] = pic.poc
        self.decoded4[gy: gy + h4, gx: gx + w4] = True

    # ---- inter prediction + reconstruction (spec 8.4.2) -----------------

    def _implicit_weights(self, pic0: RefPic, pic1: RefPic):
        """Implicit bipred weights (w0, w1) from POC distances
        (8.4.2.3.1, weighted_bipred_idc == 2; logWD fixed at 5)."""
        poc0, poc1 = pic0.poc, pic1.poc
        td = min(max(poc1 - poc0, -128), 127)
        if td == 0:
            return 32, 32
        tb = min(max(self.poc - poc0, -128), 127)
        # spec 5.6 "/": integer division truncating toward zero
        num = 16384 + abs(td) // 2
        tx = num // td if td > 0 else -(num // -td)
        dsf = min(max((tb * tx + 32) >> 6, -1024), 1023)
        if dsf >> 2 < -64 or dsf >> 2 > 128:
            return 32, 32
        w1 = dsf >> 2
        return 64 - w1, w1

    def _mc_one(self, pic: RefPic, x0: int, y0: int, px: int, py: int,
                w: int, h: int, mvx: int, mvy: int):
        from mixlab_tpu_torch.av import h264mc

        by = h264mc.luma_mc(pic.y, x0 + px, y0 + py, w, h, mvx, mvy)
        bu = h264mc.chroma_mc(pic.u, (x0 + px) // 2, (y0 + py) // 2,
                              w // 2, h // 2, mvx, mvy)
        bv = h264mc.chroma_mc(pic.v, (x0 + px) // 2, (y0 + py) // 2,
                              w // 2, h // 2, mvx, mvy)
        return by, bu, bv

    def _inter_pred_mb(self, mx: int, my: int, parts):
        """Predicted MB planes from the partition list
        [(px, py, w, h, (ref0, ref1), ((mvx0, mvy0), (mvx1, mvy1)))]
        with refN = -1 for an unused list — fractional-sample MC
        (av/h264mc.py) plus weighted sample prediction (8.4.2.3):
        explicit per-list weights, implicit POC-derived bipred weights,
        or the default (p0 + p1 + 1) >> 1 bipred average."""
        from mixlab_tpu_torch.av import h264mc

        pred_y = np.empty((16, 16), np.int64)
        pred_u = np.empty((8, 8), np.int64)
        pred_v = np.empty((8, 8), np.int64)
        y0, x0 = my * 16, mx * 16
        for px, py, w, h, refs, mvs in parts:
            used = [lx for lx in (0, 1) if refs[lx] >= 0]
            if len(used) == 1:
                lx = used[0]
                ref = refs[lx]
                pic = self.lists[lx][ref]
                by, bu, bv = self._mc_one(pic, x0, y0, px, py, w, h, *mvs[lx])
                if self.wp is not None:
                    log_y, log_c, per_list = self.wp
                    wy, oy, wu, ou, wv, ov = per_list[lx][ref]
                    by = h264mc.weight_pred(by, wy, oy, log_y)
                    bu = h264mc.weight_pred(bu, wu, ou, log_c)
                    bv = h264mc.weight_pred(bv, wv, ov, log_c)
            else:
                pic0 = self.lists[0][refs[0]]
                pic1 = self.lists[1][refs[1]]
                p0 = self._mc_one(pic0, x0, y0, px, py, w, h, *mvs[0])
                p1 = self._mc_one(pic1, x0, y0, px, py, w, h, *mvs[1])
                if self.wp is not None:  # explicit bipred (idc 1)
                    log_y, log_c, per_list = self.wp
                    e0 = per_list[0][refs[0]]
                    e1 = per_list[1][refs[1]]
                    by = h264mc.weight_bipred(
                        p0[0], p1[0], e0[0], e1[0], e0[1], e1[1], log_y)
                    bu = h264mc.weight_bipred(
                        p0[1], p1[1], e0[2], e1[2], e0[3], e1[3], log_c)
                    bv = h264mc.weight_bipred(
                        p0[2], p1[2], e0[4], e1[4], e0[5], e1[5], log_c)
                elif self.implicit_wp:
                    w0, w1 = self._implicit_weights(pic0, pic1)
                    by, bu, bv = (
                        np.clip((a * w0 + b * w1 + 32) >> 6, 0, 255)
                        for a, b in zip(p0, p1))
                else:  # default (8.4.2.3.1)
                    by, bu, bv = ((a + b + 1) >> 1 for a, b in zip(p0, p1))
            pred_y[py: py + h, px: px + w] = by
            pred_u[py // 2: (py + h) // 2, px // 2: (px + w) // 2] = bu
            pred_v[py // 2: (py + h) // 2, px // 2: (px + w) // 2] = bv
        return pred_y, pred_u, pred_v

    def _recon_inter_mb(self, mx, my, qp, Z, CZD, CZA,
                        pred_y, pred_u, pred_v):
        """Inter MB reconstruction: full 4x4 luma residual blocks (no
        separate DC transform) added to the MC prediction."""
        y0, x0 = my * 16, mx * 16
        res = (idct4x4(dequant4x4(Z, qp)) + 32) >> 6
        mb = np.empty((16, 16), np.int64)
        for i, (bx, by) in enumerate(_BLK_POS):
            mb[4 * by: 4 * by + 4, 4 * bx: 4 * bx + 4] = res[i]
        self.ry[y0: y0 + 16, x0: x0 + 16] = np.clip(pred_y + mb, 0, 255)
        self._recon_chroma(mx, my, qp, 0, CZD, CZA,
                           cpreds=(pred_u, pred_v))

    def _decode_mb_intra(self, r: BitReader, mx: int, my: int, mb_type: int):
        if mb_type == 25:  # I_PCM (§7.3.5, §8.3.5)
            r.byte_align()
            self._store_pcm(r, mx, my)
            return
        if mb_type == 0:  # I_NxN: 4x4 or 8x8 transform (High profile)
            if self.pps.transform_8x8 and r.bit():
                self._decode_i8_mb(r, mx, my)
            else:
                self._decode_i4_mb(r, mx, my)
            return
        if not 1 <= mb_type <= 24:
            raise H264DecodeError(
                f"mb_type {mb_type} unsupported (intra only)"
            )
        code = mb_type - 1
        pred_mode = code % 4
        cbp_chroma = (code // 4) % 3
        cbp_luma = 15 if code >= 12 else 0
        chroma_mode = r.ue()
        if chroma_mode > 3:
            raise H264DecodeError("bad intra_chroma_pred_mode")
        delta = r.se()  # mb_qp_delta (always present for Intra_16x16)
        qp = (self.qp_prev + delta + 52) % 52
        self.qp_prev = qp
        self.qp_map[my, mx] = qp
        self.i4_modes[my * 4 : my * 4 + 4, mx * 4 : mx * 4 + 4] = 2

        # ---- luma DC coefficients ----------------------------------------
        nC = self._nC(self.nnz_y, mx, my, 0, 0, 4)
        dc_scan = read_cavlc_block(r, nC, 16)
        ZD = np.zeros(16, np.int64)
        for i, z in enumerate(ZIGZAG):
            ZD[z] = dc_scan[i]
        ZD = ZD.reshape(4, 4)

        # ---- luma AC ------------------------------------------------------
        self.nnz_y[my * 4 : my * 4 + 4, mx * 4 : mx * 4 + 4] = 0
        ZA = np.zeros((16, 4, 4), np.int64)
        if cbp_luma:
            for i, (bx, by) in enumerate(_BLK_POS):
                nC = self._nC(self.nnz_y, mx, my, bx, by, 4)
                scan = read_cavlc_block(r, nC, 15)
                flat = np.zeros(16, np.int64)
                for k, z in enumerate(ZIGZAG[1:]):
                    flat[z] = scan[k]
                ZA[i] = flat.reshape(4, 4)
                self.nnz_y[my * 4 + by, mx * 4 + bx] = int(
                    np.count_nonzero(scan)
                )

        CZD, CZA = self._read_chroma(r, mx, my, cbp_chroma)
        self._recon_i16_mb(mx, my, pred_mode, qp, ZD, ZA,
                           chroma_mode, CZD, CZA)

    def _store_pcm(self, r, mx: int, my: int):
        """Raw I_PCM samples from an (already aligned) reader position,
        plus the PCM side effects every tier shares (§7.3.5, §8.3.5)."""
        y0, x0 = my * 16, mx * 16
        cy0, cx0 = my * 8, mx * 8
        for yy in range(16):
            for xx in range(16):
                self.ry[y0 + yy, x0 + xx] = r.bits(8)
        for plane in (self.ru, self.rv):
            for yy in range(8):
                for xx in range(8):
                    plane[cy0 + yy, cx0 + xx] = r.bits(8)
        # I_PCM sets nnz to 16 for prediction context (spec 9.2.1)
        self.nnz_y[my * 4 : my * 4 + 4, mx * 4 : mx * 4 + 4] = 16
        self.nnz_u[my * 2 : my * 2 + 2, mx * 2 : mx * 2 + 2] = 16
        self.nnz_v[my * 2 : my * 2 + 2, mx * 2 : mx * 2 + 2] = 16
        self.i4_modes[my * 4 : my * 4 + 4, mx * 4 : mx * 4 + 4] = 2
        # Deblocking qPp of an I_PCM macroblock is 0 (spec 8.7.2), but
        # the mb_qp_delta chain is NOT reset: the next coded MB chains
        # from the qp before the I_PCM MB (verified against libavcodec
        # by tests/test_h264dec_intra_full.py ipcm-chain tests)
        self.qp_map[my, mx] = 0

    def _recon_i16_mb(self, mx, my, pred_mode, qp, ZD, ZA,
                      chroma_mode, CZD, CZA):
        """Intra_16x16 reconstruction from dezigzagged coefficient arrays
        (identical math to the encoder's recon; entropy-coder agnostic)."""
        y0, x0 = my * 16, mx * 16
        has_top, has_left = my > 0, mx > 0
        qp6, rem = divmod(qp, 6)
        FD = _H4 @ ZD @ _H4
        if qp >= 12:
            dcY = (FD * _V_A[rem]) << (qp6 - 2)
        else:
            dcY = (FD * _V_A[rem] + (1 << (1 - qp6))) >> (2 - qp6)
        DQ = dequant4x4(ZA, qp)
        for i, (bx, by) in enumerate(_BLK_POS):
            DQ[i, 0, 0] = dcY[by, bx]
        pred = self._pred16(pred_mode, y0, x0, has_top, has_left)
        res = (idct4x4(DQ) + 32) >> 6
        mb = np.empty((16, 16), np.int64)
        for i, (bx, by) in enumerate(_BLK_POS):
            mb[4 * by : 4 * by + 4, 4 * bx : 4 * bx + 4] = res[i]
        self.ry[y0 : y0 + 16, x0 : x0 + 16] = np.clip(mb + pred, 0, 255)

        self._recon_chroma(mx, my, qp, chroma_mode, CZD, CZA)

    # ---- I_4x4 macroblocks (spec 7.3.5.1, 8.3.1) ----------------------

    def _tr_avail(self, mx: int, my: int, bx: int, by: int) -> bool:
        """Top-right sample availability for 4x4 block (bx,by) of MB
        (mx,my): the block holding p[4..7,-1] must be decoded already."""
        gx, gy = mx * 4 + bx, my * 4 + by
        if gy == 0 or gx + 1 >= self.mbw * 4:
            return False
        nx, ny = gx + 1, gy - 1
        nmx, nmy = nx // 4, ny // 4
        if nmy < my or (nmy == my and nmx < mx):
            return True
        if nmy == my and nmx == mx:
            return _Z_OF[(nx % 4, ny % 4)] < _Z_OF[(bx, by)]
        return False

    def _decode_i4_mb(self, r: BitReader, mx: int, my: int):
        gy0, gx0 = my * 4, mx * 4
        modes: List[int] = []
        for bx, by in _BLK_POS:
            gx, gy = gx0 + bx, gy0 + by
            ma = int(self.i4_modes[gy, gx - 1]) if gx > 0 else -1
            mb_ = int(self.i4_modes[gy - 1, gx]) if gy > 0 else -1
            pm = 2 if (ma < 0 or mb_ < 0) else min(ma, mb_)
            if r.bit():  # prev_intra4x4_pred_mode_flag
                mode = pm
            else:
                rem = r.bits(3)
                mode = rem if rem < pm else rem + 1
            self.i4_modes[gy, gx] = mode
            modes.append(mode)
        chroma_mode = r.ue()
        if chroma_mode > 3:
            raise H264DecodeError("bad intra_chroma_pred_mode")
        cbp_code = r.ue()
        if cbp_code >= len(_CBP_INTRA):
            raise H264DecodeError("bad coded_block_pattern")
        cbp = _CBP_INTRA[cbp_code]
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        if cbp:
            qp = (self.qp_prev + r.se() + 52) % 52
            self.qp_prev = qp
        else:
            qp = self.qp_prev
        self.qp_map[my, mx] = qp

        # ---- residual (entropy order: 16 luma blocks, then chroma) -------
        self.nnz_y[gy0 : gy0 + 4, gx0 : gx0 + 4] = 0
        Z = np.zeros((16, 4, 4), np.int64)
        for i, (bx, by) in enumerate(_BLK_POS):
            if not (cbp_luma >> (i >> 2)) & 1:
                continue
            nC = self._nC(self.nnz_y, mx, my, bx, by, 4)
            scan = read_cavlc_block(r, nC, 16)
            flat = np.zeros(16, np.int64)
            for k, z in enumerate(ZIGZAG):
                flat[z] = scan[k]
            Z[i] = flat.reshape(4, 4)
            self.nnz_y[gy0 + by, gx0 + bx] = int(np.count_nonzero(scan))
        CZD, CZA = self._read_chroma(r, mx, my, cbp_chroma)
        self._recon_i4_mb(mx, my, modes, qp, Z, chroma_mode, CZD, CZA)

    def _recon_i4_mb(self, mx, my, modes, qp, Z, chroma_mode, CZD, CZA):
        """I_4x4 reconstruction: Z-order, each block predicts from recon
        (entropy-coder agnostic)."""
        gy0, gx0 = my * 4, mx * 4
        res = (idct4x4(dequant4x4(Z, qp)) + 32) >> 6
        for i, (bx, by) in enumerate(_BLK_POS):
            yb, xb = my * 16 + 4 * by, mx * 16 + 4 * bx
            pred = _pred4x4(
                self.ry, yb, xb, modes[i],
                (gy0 + by) > 0, (gx0 + bx) > 0,
                self._tr_avail(mx, my, bx, by),
            )
            self.ry[yb : yb + 4, xb : xb + 4] = np.clip(
                pred + res[i], 0, 255
            )
        self._recon_chroma(mx, my, qp, chroma_mode, CZD, CZA)

    # ---- I_8x8 macroblocks + 8x8 luma residual (High profile) ----------

    def _read_luma8_cavlc(self, r: BitReader, mx: int, my: int,
                          cbp_luma: int) -> np.ndarray:
        """CAVLC 8x8 luma residual (7.4.5.3.3): each coded 8x8 block is
        four interleaved 4x4 CAVLC blocks — sub-block k supplies 8x8
        scan positions 4*i + k.  Maintains per-4x4 nnz (nC contexts) and
        per-8x8 coded flags (deblocking bS)."""
        Z8 = np.zeros((4, 8, 8), np.int64)
        gy0, gx0 = my * 4, mx * 4
        self.nnz_y[gy0: gy0 + 4, gx0: gx0 + 4] = 0
        for b8 in range(4):
            if not (cbp_luma >> b8) & 1:
                continue
            flat = np.zeros(64, np.int64)
            for k in range(4):
                bx, by = _BLK_POS[b8 * 4 + k]
                nC = self._nC(self.nnz_y, mx, my, bx, by, 4)
                scan = read_cavlc_block(r, nC, 16)
                self.nnz_y[gy0 + by, gx0 + bx] = int(
                    np.count_nonzero(scan))
                for i in range(16):
                    flat[ZIGZAG8[4 * i + k]] = scan[i]
            Z8[b8] = flat.reshape(8, 8)
            self.coded8[my * 2 + (b8 >> 1), mx * 2 + (b8 & 1)] = bool(
                flat.any())
        return Z8

    def _read_i8_modes_cavlc(self, r: BitReader, mx: int, my: int):
        gy0, gx0 = my * 4, mx * 4
        modes = []
        for b8 in range(4):
            gx, gy = gx0 + (b8 & 1) * 2, gy0 + (b8 >> 1) * 2
            ma = int(self.i4_modes[gy, gx - 1]) if gx > 0 else -1
            mb_ = int(self.i4_modes[gy - 1, gx]) if gy > 0 else -1
            pm = 2 if (ma < 0 or mb_ < 0) else min(ma, mb_)
            if r.bit():  # prev_intra8x8_pred_mode_flag
                mode = pm
            else:
                rem = r.bits(3)
                mode = rem if rem < pm else rem + 1
            self.i4_modes[gy: gy + 2, gx: gx + 2] = mode
            modes.append(mode)
        return modes

    def _decode_i8_mb(self, r: BitReader, mx: int, my: int):
        """I_NxN with transform_size_8x8_flag == 1 (spec 7.3.5.1,
        8.3.2)."""
        self.t8[my, mx] = True
        modes = self._read_i8_modes_cavlc(r, mx, my)
        chroma_mode = r.ue()
        if chroma_mode > 3:
            raise H264DecodeError("bad intra_chroma_pred_mode")
        cbp_code = r.ue()
        if cbp_code >= len(_CBP_INTRA):
            raise H264DecodeError("bad coded_block_pattern")
        cbp = _CBP_INTRA[cbp_code]
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        if cbp:
            qp = (self.qp_prev + r.se() + 52) % 52
            self.qp_prev = qp
        else:
            qp = self.qp_prev
        self.qp_map[my, mx] = qp
        Z8 = self._read_luma8_cavlc(r, mx, my, cbp_luma)
        CZD, CZA = self._read_chroma(r, mx, my, cbp_chroma)
        self._recon_i8_mb(mx, my, modes, qp, Z8, chroma_mode, CZD, CZA)

    def _i8_avail(self, mx: int, my: int, b8: int):
        """(y0, x0, has_top, has_left, has_top_right) of 8x8 block b8;
        top-right follows raster decode order (6.4.9)."""
        y0 = my * 16 + (b8 >> 1) * 8
        x0 = mx * 16 + (b8 & 1) * 8
        has_top = y0 > 0
        has_left = x0 > 0
        if b8 == 0:
            has_tr = has_top
        elif b8 == 1:  # above-right macroblock
            has_tr = my > 0 and mx < self.mbw - 1
        elif b8 == 2:  # bottom row of block 1's region, same MB
            has_tr = True
        else:
            has_tr = False
        return y0, x0, has_top, has_left, has_tr

    def _recon_i8_mb(self, mx, my, modes, qp, Z8, chroma_mode, CZD, CZA):
        for b8 in range(4):
            y0, x0, ht, hl, htr = self._i8_avail(mx, my, b8)
            pred = _pred8x8(self.ry, y0, x0, modes[b8], ht, hl, htr)
            res = (idct8x8(dequant8x8(Z8[b8], qp)) + 32) >> 6
            self.ry[y0: y0 + 8, x0: x0 + 8] = np.clip(pred + res, 0, 255)
        self._recon_chroma(mx, my, qp, chroma_mode, CZD, CZA)

    def _recon_inter_mb8(self, mx, my, qp, Z8, CZD, CZA,
                         pred_y, pred_u, pred_v):
        """Inter MB reconstruction with the 8x8 transform."""
        y0, x0 = my * 16, mx * 16
        for b8 in range(4):
            by0, bx0 = (b8 >> 1) * 8, (b8 & 1) * 8
            res = (idct8x8(dequant8x8(Z8[b8], qp)) + 32) >> 6
            self.ry[y0 + by0: y0 + by0 + 8, x0 + bx0: x0 + bx0 + 8] = \
                np.clip(pred_y[by0: by0 + 8, bx0: bx0 + 8] + res, 0, 255)
        self._recon_chroma(mx, my, qp, 0, CZD, CZA,
                           cpreds=(pred_u, pred_v))

    # ---- shared chroma residual + reconstruction ----------------------

    def _read_chroma(self, r: BitReader, mx: int, my: int, cbp_chroma: int):
        CZD = [np.zeros((2, 2), np.int64), np.zeros((2, 2), np.int64)]
        CZA = [np.zeros((4, 4, 4), np.int64), np.zeros((4, 4, 4), np.int64)]
        if cbp_chroma:
            for comp in range(2):
                scan = read_cavlc_block(r, -1, 4)
                CZD[comp] = np.array(
                    [[scan[0], scan[1]], [scan[2], scan[3]]], np.int64
                )
        for comp in range(2):
            nnz_c = self.nnz_u if comp == 0 else self.nnz_v
            nnz_c[my * 2 : my * 2 + 2, mx * 2 : mx * 2 + 2] = 0
            if cbp_chroma == 2:
                for i in range(4):
                    nC = self._nC(nnz_c, mx, my, i % 2, i // 2, 2)
                    scan = read_cavlc_block(r, nC, 15)
                    flat = np.zeros(16, np.int64)
                    for k, z in enumerate(ZIGZAG[1:]):
                        flat[z] = scan[k]
                    CZA[comp][i] = flat.reshape(4, 4)
                    nnz_c[my * 2 + i // 2, mx * 2 + i % 2] = int(
                        np.count_nonzero(scan)
                    )
        return CZD, CZA

    def _recon_chroma(self, mx, my, qp, chroma_mode, CZD, CZA, cpreds=None):
        cy0, cx0 = my * 8, mx * 8
        has_top, has_left = my > 0, mx > 0
        for comp in range(2):
            recon = self.ru if comp == 0 else self.rv
            qpc = self._qpc(qp, comp)
            cqp6, crem = divmod(qpc, 6)
            if cpreds is not None:  # inter MB: MC prediction (8.4.2)
                cpred = cpreds[comp]
            else:
                cpred = self._predc(recon, chroma_mode, cy0, cx0,
                                    has_top, has_left)
            CF2 = _H2 @ CZD[comp] @ _H2
            dcC = ((CF2 * _V_A[crem]) << cqp6) >> 1
            CDQ = dequant4x4(CZA[comp], qpc)
            for i in range(4):
                CDQ[i, 0, 0] = dcC[i // 2, i % 2]
            cres = (idct4x4(CDQ) + 32) >> 6
            cmb = np.empty((8, 8), np.int64)
            for i in range(4):
                sy, sx = 4 * (i // 2), 4 * (i % 2)
                cmb[sy : sy + 4, sx : sx + 4] = cres[i]
            recon[cy0 : cy0 + 8, cx0 : cx0 + 8] = np.clip(
                cmb + cpred, 0, 255
            )

    # ---- full-size intra prediction dispatch (spec 8.3.2 / 8.3.4) ------

    def _pred16(self, mode, y0, x0, has_top, has_left):
        ry = self.ry
        if mode == 2:
            return _dc_pred16(ry, y0, x0, has_top, has_left)
        if mode == 0:  # Vertical
            if not has_top:
                raise H264DecodeError("Intra_16x16 V without top")
            return ry[y0 - 1, x0 : x0 + 16][None, :].astype(np.int64)
        if mode == 1:  # Horizontal
            if not has_left:
                raise H264DecodeError("Intra_16x16 H without left")
            return ry[y0 : y0 + 16, x0 - 1][:, None].astype(np.int64)
        # mode 3: Plane
        if not (has_top and has_left):
            raise H264DecodeError("Intra_16x16 Plane without neighbors")
        t = ry[y0 - 1, x0 - 1 : x0 + 16].astype(np.int64)  # t[1+x]=p[x,-1]
        lf = ry[y0 - 1 : y0 + 16, x0 - 1].astype(np.int64)
        h = sum((x + 1) * (int(t[9 + x]) - int(t[7 - x])) for x in range(8))
        v = sum((y + 1) * (int(lf[9 + y]) - int(lf[7 - y]))
                for y in range(8))
        a = 16 * (int(lf[16]) + int(t[16]))
        b = (5 * h + 32) >> 6
        c = (5 * v + 32) >> 6
        xs = np.arange(16, dtype=np.int64)
        return np.clip(
            (a + b * (xs[None, :] - 7) + c * (xs[:, None] - 7) + 16) >> 5,
            0, 255,
        )

    def _predc(self, recon, mode, cy0, cx0, has_top, has_left):
        if mode == 0:
            return _dc_pred_chroma(recon, cy0, cx0, has_top, has_left)
        if mode == 1:  # Horizontal
            if not has_left:
                raise H264DecodeError("chroma H prediction without left")
            return recon[cy0 : cy0 + 8, cx0 - 1][:, None].astype(np.int64)
        if mode == 2:  # Vertical
            if not has_top:
                raise H264DecodeError("chroma V prediction without top")
            return recon[cy0 - 1, cx0 : cx0 + 8][None, :].astype(np.int64)
        if not (has_top and has_left):
            raise H264DecodeError("chroma Plane prediction w/o neighbors")
        t = recon[cy0 - 1, cx0 - 1 : cx0 + 8].astype(np.int64)
        lf = recon[cy0 - 1 : cy0 + 8, cx0 - 1].astype(np.int64)
        h = sum((x + 1) * (int(t[5 + x]) - int(t[3 - x])) for x in range(4))
        v = sum((y + 1) * (int(lf[5 + y]) - int(lf[3 - y]))
                for y in range(4))
        a = 16 * (int(lf[8]) + int(t[8]))
        b = (17 * h + 16) >> 5
        c = (17 * v + 16) >> 5
        xs = np.arange(8, dtype=np.int64)
        return np.clip(
            (a + b * (xs[None, :] - 3) + c * (xs[:, None] - 3) + 16) >> 5,
            0, 255,
        )

    # ---- deblocking (spec 8.7): MBs in raster order, all vertical
    # edges of an MB left-to-right, then all horizontal top-to-bottom ----

    def _deblock(self, off_a: int, off_b: int):
        qpm = self.qp_map
        for my in range(self.mbh):
            for mx in range(self.mbw):
                qq = int(qpm[my, mx])
                y0, x0 = my * 16, mx * 16
                cy0, cx0 = my * 8, mx * 8
                for vertical in (True, False):
                    for xr in (0, 4, 8, 12):
                        if xr == 0:
                            if (mx if vertical else my) == 0:
                                continue
                            bs = 4
                            qp_p = int(qpm[my, mx - 1] if vertical
                                       else qpm[my - 1, mx])
                        else:
                            bs = 3  # internal edge of an intra MB
                            qp_p = qq
                        qav = (qp_p + qq + 1) >> 1
                        ia = int(np.clip(qav + off_a, 0, 51))
                        ib = int(np.clip(qav + off_b, 0, 51))
                        if vertical:
                            _edge_filter(self.ry, y0, x0 + xr, 16, True,
                                         bs, ia, ib, False)
                        else:
                            _edge_filter(self.ry, y0 + xr, x0, 16, False,
                                         bs, ia, ib, False)
                        if xr in (0, 8):
                            for comp, plane in ((0, self.ru), (1, self.rv)):
                                cq = (self._qpc(qp_p, comp)
                                      + self._qpc(qq, comp) + 1) >> 1
                                ia = int(np.clip(cq + off_a, 0, 51))
                                ib = int(np.clip(cq + off_b, 0, 51))
                                if vertical:
                                    _edge_filter(plane, cy0, cx0 + xr // 2,
                                                 8, True, bs, ia, ib, True)
                                else:
                                    _edge_filter(plane, cy0 + xr // 2, cx0,
                                                 8, False, bs, ia, ib, True)

    # ---- deblocking with derived boundary strengths (spec 8.7.2.1) ------

    def _cell_coeffs(self, gy: int, gx: int) -> bool:
        """Non-zero-coefficient test for bS (8.7.2.1): cells of an
        8x8-transform MB consult the containing 8x8 block."""
        if self.t8[gy >> 2, gx >> 2]:
            return bool(self.coded8[gy >> 1, gx >> 1])
        return bool(self.nnz_y[gy, gx])

    @staticmethod
    def _mv_far(a, b) -> bool:
        return (abs(int(a[0]) - int(b[0])) >= 4
                or abs(int(a[1]) - int(b[1])) >= 4)

    def _bs(self, pgx: int, pgy: int, qgx: int, qgy: int,
            any_intra: bool, mb_edge: bool) -> int:
        """Boundary strength for the edge between 4x4 blocks p (pgx, pgy)
        and q (qgx, qgy) (8.7.2.1).  For bi-predicted blocks the rule
        compares the USED reference pictures as a set (which list holds a
        picture does not matter), and when both blocks use the same two
        pictures the MV comparison may match either correspondence."""
        if any_intra:
            return 4 if mb_edge else 3
        if self._cell_coeffs(pgy, pgx) or self._cell_coeffs(qgy, qgx):
            return 2
        p_used = [lx for lx in (0, 1) if self.refidx[pgy, pgx, lx] >= 0]
        q_used = [lx for lx in (0, 1) if self.refidx[qgy, qgx, lx] >= 0]
        if len(p_used) != len(q_used):
            return 1
        p_pids = sorted(int(self.refpid[pgy, pgx, lx]) for lx in p_used)
        q_pids = sorted(int(self.refpid[qgy, qgx, lx]) for lx in q_used)
        if p_pids != q_pids:
            return 1
        if len(p_used) == 1:
            if self._mv_far(self.mv[pgy, pgx, p_used[0]],
                            self.mv[qgy, qgx, q_used[0]]):
                return 1
            return 0
        pm0, pm1 = self.mv[pgy, pgx, 0], self.mv[pgy, pgx, 1]
        qm0, qm1 = self.mv[qgy, qgx, 0], self.mv[qgy, qgx, 1]
        ppid0 = int(self.refpid[pgy, pgx, 0])
        qpid0 = int(self.refpid[qgy, qgx, 0])
        straight_far = (self._mv_far(pm0, qm0) or self._mv_far(pm1, qm1))
        if ppid0 != int(self.refpid[pgy, pgx, 1]):
            # two distinct pictures: compare per-picture (lists may be
            # swapped between the blocks)
            if ppid0 == qpid0:
                return 1 if straight_far else 0
            return 1 if (self._mv_far(pm0, qm1)
                         or self._mv_far(pm1, qm0)) else 0
        # same picture in both lists: bS 0 if EITHER correspondence is
        # near (8.7.2.1 last clause)
        cross_far = (self._mv_far(pm0, qm1) or self._mv_far(pm1, qm0))
        return 1 if (straight_far and cross_far) else 0

    def _deblock_general(self, off_a: int, off_b: int):
        """§8.7 deblocking for pictures with inter MBs: per-4x4-edge bS
        (8.7.2.1) instead of the all-intra constants; chroma edges reuse
        the co-located luma bS.  Same MB/edge ordering as ``_deblock``."""
        qpm = self.qp_map
        for my in range(self.mbh):
            for mx in range(self.mbw):
                qq = int(qpm[my, mx])
                intra_q = bool(self.mb_intra[my, mx])
                y0, x0 = my * 16, mx * 16
                cy0, cx0 = my * 8, mx * 8
                for vertical in (True, False):
                    for xr in (0, 4, 8, 12):
                        if xr == 0:
                            if (mx if vertical else my) == 0:
                                continue
                            pmx, pmy = (mx - 1, my) if vertical else (mx, my - 1)
                        else:
                            # 8x8-transform MBs have no internal 4x4
                            # transform edges (8.7: filterInternalEdges)
                            if xr != 8 and self.t8[my, mx]:
                                continue
                            pmx, pmy = mx, my
                        qp_p = int(qpm[pmy, pmx])
                        any_intra = intra_q or bool(self.mb_intra[pmy, pmx])
                        qav = (qp_p + qq + 1) >> 1
                        ia = int(np.clip(qav + off_a, 0, 51))
                        ib = int(np.clip(qav + off_b, 0, 51))
                        for seg in range(4):
                            if vertical:
                                qgx, qgy = mx * 4 + xr // 4, my * 4 + seg
                                pgx, pgy = qgx - 1, qgy
                            else:
                                qgx, qgy = mx * 4 + seg, my * 4 + xr // 4
                                pgx, pgy = qgx, qgy - 1
                            bs = self._bs(pgx, pgy, qgx, qgy,
                                          any_intra, xr == 0)
                            if bs == 0:
                                continue
                            if vertical:
                                _edge_filter(self.ry, y0 + 4 * seg, x0 + xr,
                                             4, True, bs, ia, ib, False)
                            else:
                                _edge_filter(self.ry, y0 + xr, x0 + 4 * seg,
                                             4, False, bs, ia, ib, False)
                            if xr in (0, 8):
                                for comp, plane in ((0, self.ru),
                                                    (1, self.rv)):
                                    cq = (self._qpc(qp_p, comp)
                                          + self._qpc(qq, comp) + 1) >> 1
                                    ca = int(np.clip(cq + off_a, 0, 51))
                                    cb = int(np.clip(cq + off_b, 0, 51))
                                    if vertical:
                                        _edge_filter(
                                            plane, cy0 + 2 * seg,
                                            cx0 + xr // 2, 2, True,
                                            bs, ca, cb, True)
                                    else:
                                        _edge_filter(
                                            plane, cy0 + xr // 2,
                                            cx0 + 2 * seg, 2, False,
                                            bs, ca, cb, True)


# ---------------------------------------------------------------------------
# frame-level API
# ---------------------------------------------------------------------------


def split_annexb(data: bytes) -> List[bytes]:
    """Annex-B start-code split -> raw NAL units (with header byte)."""
    out = []
    i = 0
    n = len(data)
    while i < n:
        # find next start code
        sc = data.find(b"\x00\x00\x01", i)
        if sc < 0:
            break
        start = sc + 3
        nxt = data.find(b"\x00\x00\x01", start)
        end = n if nxt < 0 else (nxt - 1 if nxt > 0 and data[nxt - 1] == 0 else nxt)
        unit = data[start:end]
        while unit and unit[-1] == 0:
            unit = unit[:-1]
        if unit:
            out.append(unit)
        i = start if nxt < 0 else nxt
        if nxt < 0:
            break
    return out


def split_avcc(data: bytes, length_size: int = 4) -> List[bytes]:
    out = []
    i = 0
    while i + length_size <= len(data):
        ln = int.from_bytes(data[i : i + length_size], "big")
        i += length_size
        out.append(data[i : i + ln])
        i += ln
    return out


class PureH264Decoder:
    """Stateful decoder, duck-type compatible with avshim.VideoDecoder:
    feed DCR extradata at construction, then ``decode(avcc_payload)`` ->
    [(pts, y, u, v)] in DISPLAY order (B-frame streams reorder by POC
    with the VUI max_num_reorder_frames delay; ``flush()`` drains)."""

    def __init__(self, extradata: bytes = b""):
        self.sps: Optional[_SpsExt] = None
        self.pps: Optional[_Pps] = None
        self.length_size = 4
        self.dpb = Dpb()
        # display-order reordering (C.4.5 bumping): [(poc, pts, planes)]
        self._reorder: List[Tuple[int, int, Tuple]] = []
        self._seen_b = False
        self._order_fallback = 0  # POC surrogate when untracked (type 1)
        if extradata:
            from mixlab_tpu_torch.av.avc import DecoderConfigurationRecord

            dcr = DecoderConfigurationRecord.parse(extradata)
            self.length_size = dcr.nalu_size
            for nu in list(dcr.sps) + list(dcr.pps):
                kind = int(getattr(nu.kind, "value", nu.kind))
                self._feed_nal(bytes([(nu.ref_idc << 5) | kind]) + nu.data)

    @property
    def _reorder_depth(self) -> int:
        """Frames held back for display-order output: the stream's VUI
        max_num_reorder_frames when present, else the DPB size for a
        stream whose profile allows B slices (any but baseline, 66) or
        once a B slice is seen, and 0 for baseline (P/I streams never
        reorder).  The JAX package waits for the first B slice, so a
        stream without the VUI bound emits its first GOP's P picture
        before the B pictures that precede it in display order."""
        if self.sps is not None and self.sps.num_reorder_frames is not None:
            return self.sps.num_reorder_frames
        if self.sps is not None and (self._seen_b or self.sps.info.profile_idc != 66):
            return max(self.sps.max_num_ref_frames, 1)
        return 0

    def _peek_poc(self, rbsp: bytes, nal_type: int,
                  nal_ref_idc: int) -> Optional[int]:
        """POC of a slice whose decode tier does not track it (the fast
        intra tiers): re-parse the header prefix and run the shared
        8.2.1 computation against the DPB predictor state."""
        r = BitReader(rbsp)
        r.ue()  # first_mb_in_slice
        r.ue()  # slice_type
        r.ue()  # pps id
        shell = _SliceDecoder.__new__(_SliceDecoder)
        shell.sps, shell.pps, shell.dpb = self.sps, self.pps, self.dpb
        shell.frame_num = r.bits(self.sps.log2_max_frame_num)
        shell.is_ref = nal_ref_idc != 0
        if nal_type == 5:
            r.ue()  # idr_pic_id
        return shell._compute_poc(r, nal_type)

    def _drain(self) -> List[Tuple]:
        out = [(pts, *planes) for _poc, pts, planes
               in sorted(self._reorder, key=lambda t: t[0])]
        self._reorder.clear()
        return out

    def _push_frame(self, poc: int, pts: int, planes) -> List[Tuple]:
        """Display-order bumping (C.4.5): hold up to _reorder_depth
        frames, emitting the lowest-POC ones."""
        self._reorder.append((poc, pts, planes))
        out = []
        while len(self._reorder) > self._reorder_depth:
            i = min(range(len(self._reorder)),
                    key=lambda k: self._reorder[k][0])
            _poc, fpts, fplanes = self._reorder.pop(i)
            out.append((fpts, *fplanes))
        return out

    def _feed_nal(self, unit: bytes, pts: int = 0) -> List[Tuple]:
        # every bit-level read below (SPS, PPS, slice headers, CAVLC) uses
        # sps.py's reader, whose truncation/Exp-Golomb failures are
        # SpsError; convert once at the ingest boundary so untrusted bytes
        # can only ever surface H264DecodeError (deepfuzz h264_dcr leak)
        from mixlab_tpu_torch.av.sps import SpsError

        try:
            return self._feed_nal_inner(unit, pts)
        except SpsError as e:
            raise H264DecodeError(f"bitstream truncated/corrupt: {e}") from e

    def _feed_nal_inner(self, unit: bytes, pts: int) -> List[Tuple]:
        if not unit:
            return []
        nal_type = unit[0] & 0x1F
        rbsp = unit[1:]
        if nal_type == 7:
            sps = _SpsExt(rbsp)
            if self.sps is not None and (sps.mb_width, sps.mb_height) != (
                    self.sps.mb_width, self.sps.mb_height):
                # new picture dimensions: the stored references no longer
                # fit (the spec requires an IDR next anyway)
                self.dpb.clear()
            self.sps = sps
            return []
        if nal_type == 8:
            self.pps = _Pps(rbsp)
            return []
        if nal_type in (1, 5):
            if self.sps is None or self.pps is None:
                raise H264DecodeError("slice before SPS/PPS")
            import os

            nal_ref_idc = (unit[0] >> 5) & 3
            # route by slice type: intra-IDR pictures keep the fast intra
            # tiers (their header parse predates the inter support and
            # assumes all-IDR intra streams); P slices go to the native
            # inter tier, falling back to the Python tiers; non-IDR intra
            # uses the Python tiers with the full header parser
            pr = BitReader(rbsp)
            pr.ue()  # first_mb_in_slice
            slice_type_peek = pr.ue() % 5
            is_intra_idr = nal_type == 5 and slice_type_peek == 2
            scalar_only = os.environ.get(
                "MIXLAB_PURE_H264_SCALAR", "0") == "1"
            if slice_type_peek == 1:
                self._seen_b = True
            dec = None
            # the native tiers do not implement the High-profile 8x8
            # transform yet: such streams decode on the Python tiers
            t8_stream = self.pps.transform_8x8
            if slice_type_peek in (0, 1) and not scalar_only \
                    and not t8_stream:
                # native inter tier (P and B slices, CAVLC and CABAC;
                # C++ macroblock layer with per-4x4 motion export so B
                # direct modes can consult stored references)
                from mixlab_tpu_torch.av.h264dec_fast import (
                    NativeInterSliceDecoder,
                )

                nd = NativeInterSliceDecoder(self.sps, self.pps, self.dpb)
                if nd.decode_slice(BitReader(rbsp), nal_type, nal_ref_idc):
                    dec = nd
            if dec is not None:
                pass
            elif self.pps.entropy_cabac:
                # CABAC entropy tier: native C++ twin first, Python
                # scalar fallback (both share this module's recon math)
                from mixlab_tpu_torch.av.h264cabac import (
                    CabacSliceDecoder,
                    NativeCabacSliceDecoder,
                )

                if is_intra_idr and not scalar_only and not t8_stream:
                    dec = NativeCabacSliceDecoder(self.sps, self.pps)
                    if not dec.decode_slice(BitReader(rbsp), nal_type):
                        dec = None
                if dec is None:
                    dec = CabacSliceDecoder(self.sps, self.pps, self.dpb)
                    dec.decode_slice(BitReader(rbsp), nal_type, nal_ref_idc)
            elif not is_intra_idr or t8_stream:
                # CAVLC inter (no native lib), non-IDR intra, and
                # High-profile streams: the scalar tier owns the full
                # slice-header + 8x8-transform semantics
                dec = _SliceDecoder(self.sps, self.pps, self.dpb)
                dec.decode_slice(BitReader(rbsp), nal_type, nal_ref_idc)
            elif scalar_only:
                dec = _SliceDecoder(self.sps, self.pps, self.dpb)
                dec.decode_slice(BitReader(rbsp), nal_type, nal_ref_idc)
            else:
                # tier 1: C++ full baseline-intra decoder (all modes +
                # deblocking; tests/test_h264dec_intra_full.py).
                # tier 2 (no native lib): vectorized two-pass Python
                # decoder for the fast-path stream shapes
                # (tests/test_h264dec_fast.py), falling back on the typed
                # H264Unsupported to
                # tier 3: the scalar oracle, which covers the whole intra
                # toolset.
                from mixlab_tpu_torch.av.h264dec_fast import (
                    FastSliceDecoder,
                    NativeFullSliceDecoder,
                )

                dec = None
                if os.environ.get("MIXLAB_PURE_H264_PYFULL", "0") != "1":
                    nd = NativeFullSliceDecoder(self.sps, self.pps)
                    if nd.decode_slice(BitReader(rbsp), nal_type):
                        dec = nd
                if dec is None:
                    try:
                        dec = FastSliceDecoder(self.sps, self.pps)
                        dec.decode_slice(BitReader(rbsp), nal_type)
                    except H264Unsupported:
                        dec = _SliceDecoder(self.sps, self.pps, self.dpb)
                        dec.decode_slice(BitReader(rbsp), nal_type,
                                         nal_ref_idc)
            full_y = np.clip(dec.ry, 0, 255).astype(np.uint8)
            full_u = np.clip(dec.ru, 0, 255).astype(np.uint8)
            full_v = np.clip(dec.rv, 0, 255).astype(np.uint8)
            # display order: POC from the tier's header parse when it
            # tracks one, else the shared 8.2.1 computation over a header
            # re-peek (fast intra tiers); decode order as a last resort
            # (POC type 1 — no reordering encoder in scope emits it)
            poc = getattr(dec, "poc", None)
            if poc is None:
                poc = self._peek_poc(rbsp, nal_type, nal_ref_idc)
            if poc is None:
                poc = self._order_fallback
                self._order_fallback += 1
            # reference picture marking (8.2.5): IDR resets the buffer
            # (prior pictures drain to output first); the fast intra
            # tiers decode IDR-only streams, so their default
            # frame_num/marking attributes are the IDR values
            out = self._drain() if nal_type == 5 else []
            if nal_type == 5:
                self.dpb.clear()
            if nal_ref_idc != 0:
                # per-4x4 motion rides along for B direct modes; intra
                # pictures record the cheap all-intra marker
                mv = getattr(dec, "mv", None)
                if mv is not None and getattr(mv, "ndim", 0) == 4:
                    motion = (mv.astype(np.int16),
                              dec.refidx.astype(np.int8),
                              dec.refpid.astype(np.int64),
                              dec.refpoc.astype(np.int64))
                elif slice_type_peek == 2:
                    motion = "intra"
                else:
                    motion = None  # native inter tier: no export (yet)
                frame_num = getattr(dec, "frame_num", 0)
                for op, diff in getattr(dec, "marking_ops", []):
                    if op == 1:
                        max_fn = 1 << self.sps.log2_max_frame_num
                        self.dpb.mmco_forget_short(
                            frame_num - diff, frame_num, max_fn)
                if getattr(dec, "adaptive_marking", False):
                    self.dpb.pics.append(RefPic(
                        self.dpb._next_pid, frame_num,
                        full_y, full_u, full_v, poc, motion))
                    self.dpb._next_pid += 1
                else:
                    self.dpb.store(frame_num, full_y, full_u, full_v,
                                   self.sps.max_num_ref_frames, poc, motion)
            w, h = self.sps.info.width, self.sps.info.height
            planes = (full_y[:h, :w], full_u[: h // 2, : w // 2],
                      full_v[: h // 2, : w // 2])
            out.extend(self._push_frame(poc, pts, planes))
            return out
        return []  # SEI/AUD/filler: ignored

    def decode(self, packet: bytes, pts: int = 0):
        out = []
        for unit in split_avcc(packet, self.length_size):
            out.extend(self._feed_nal(unit, pts))
        return out

    def decode_annexb(self, data: bytes, pts: int = 0):
        out = []
        for unit in split_annexb(data):
            out.extend(self._feed_nal(unit, pts))
        return out

    def flush(self):
        """Drain the display-order reorder buffer (end of stream)."""
        return self._drain()

    def close(self):
        pass


def decode_annexb_frame(data: bytes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-shot: decode an Annex-B access unit containing SPS+PPS+IDR."""
    dec = PureH264Decoder()
    frames = dec.decode_annexb(data) + dec.flush()
    if not frames:
        raise H264DecodeError("no decodable slice in stream")
    _, y, u, v = frames[-1]
    return y, u, v
