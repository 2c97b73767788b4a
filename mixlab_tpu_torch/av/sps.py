"""H.264 Sequence Parameter Set parsing (Exp-Golomb bitstream).
(the port's copy of ``mixlab_tpu/av/sps.py``)

The reference gets picture dimensions from ffmpeg's decoder context; this
build parses the SPS directly (ITU-T H.264 §7.3.2.1) so the RTMP video path
can size raw decoded frames without probing.  Handles emulation-prevention
bytes and the common profiles (Baseline/Main/High incl. chroma_format_idc).
"""

from __future__ import annotations

from dataclasses import dataclass


class SpsError(Exception):
    pass


class _BitReader:
    def __init__(self, data: bytes):
        # strip emulation prevention: 00 00 03 xx -> 00 00 xx.  bytes.replace
        # is leftmost non-overlapping, exactly the scan the spec describes
        # (each match consumes its three bytes before rescanning).
        self.data = bytes(data).replace(b"\x00\x00\x03", b"\x00\x00")
        self.pos = 0

    def bit(self) -> int:
        byte = self.pos >> 3
        if byte >= len(self.data):
            raise SpsError("SPS truncated")
        b = (self.data[byte] >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return b

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def ue(self) -> int:
        zeros = 0
        while self.bit() == 0:
            zeros += 1
            if zeros > 31:
                raise SpsError("bad Exp-Golomb code")
        return (1 << zeros) - 1 + (self.bits(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)


@dataclass
class SpsInfo:
    profile_idc: int
    level_idc: int
    width: int
    height: int


def parse_sps(rbsp: bytes) -> SpsInfo:
    """Parse an SPS RBSP (payload after the NAL header byte)."""
    r = _BitReader(rbsp)
    profile_idc = r.bits(8)
    r.bits(8)  # constraint flags + reserved
    level_idc = r.bits(8)
    r.ue()  # seq_parameter_set_id

    chroma_format_idc = 1
    if profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135):
        chroma_format_idc = r.ue()
        if chroma_format_idc == 3:
            r.bit()  # separate_colour_plane_flag
        r.ue()  # bit_depth_luma_minus8
        r.ue()  # bit_depth_chroma_minus8
        r.bit()  # qpprime_y_zero_transform_bypass_flag
        if r.bit():  # seq_scaling_matrix_present_flag
            count = 8 if chroma_format_idc != 3 else 12
            for i in range(count):
                if r.bit():  # seq_scaling_list_present_flag[i]
                    size = 16 if i < 6 else 64
                    last, nxt = 8, 8
                    for _ in range(size):
                        if nxt != 0:
                            nxt = (last + r.se() + 256) % 256
                        last = nxt if nxt != 0 else last

    r.ue()  # log2_max_frame_num_minus4
    pic_order_cnt_type = r.ue()
    if pic_order_cnt_type == 0:
        r.ue()
    elif pic_order_cnt_type == 1:
        r.bit()
        r.se()
        r.se()
        for _ in range(r.ue()):
            r.se()
    r.ue()  # max_num_ref_frames
    r.bit()  # gaps_in_frame_num_value_allowed_flag
    pic_width_in_mbs = r.ue() + 1
    pic_height_in_map_units = r.ue() + 1
    frame_mbs_only = r.bit()
    if not frame_mbs_only:
        r.bit()  # mb_adaptive_frame_field_flag
    r.bit()  # direct_8x8_inference_flag

    width = pic_width_in_mbs * 16
    height = pic_height_in_map_units * 16 * (1 if frame_mbs_only else 2)

    if r.bit():  # frame_cropping_flag
        left, right, top, bottom = r.ue(), r.ue(), r.ue(), r.ue()
        if chroma_format_idc == 1:
            cw, ch = 2, 2
        elif chroma_format_idc == 2:
            cw, ch = 2, 1
        elif chroma_format_idc == 0:
            cw, ch = 1, 1
        else:
            cw, ch = 1, 1
        ch *= 1 if frame_mbs_only else 2
        width -= (left + right) * cw
        height -= (top + bottom) * ch

    return SpsInfo(profile_idc, level_idc, width, height)
