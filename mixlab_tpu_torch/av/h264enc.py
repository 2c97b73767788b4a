"""Pure-Python H.264 intra encoder (no x264, no ffmpeg).
(the port's copy of ``mixlab_tpu/av/h264enc.py``)

Capability layer for the reference's monitor/broadcast encode path
(``codec/src/avc/encode.rs``, ``src/video/encode.rs:224-308``): the monitor
profile is all-key-frames (gop=1, ``src/module/monitor.rs:21-22``), which an
intra-only encoder covers exactly.  Two modes:

  * **I_PCM** — every macroblock stored raw (ITU-T H.264 §7.3.5 / §8.3.5).
    Bit-exact lossless, trivially compliant, large bitrate.  Used as the
    correctness baseline and round-trip oracle.
  * **CAVLC intra** — Intra_16x16 luma prediction + 4x4 integer transform +
    quantization + CAVLC entropy coding (§7.3.5.3.2, §9.2): real
    compression for the MSE monitor.  The transform/quant stage is
    vectorized over all macroblocks (numpy; the same batched shape on torch
    tensors is ``h264cavlc.transform_quant``).

Output is Annex-B or AVCC (length-prefixed) access units plus an
AVCDecoderConfigurationRecord via ``av/avc.py``, feeding ``av/mp4.py``'s
fragmented-MP4 mux for MSE exactly like the reference's pipeline
(``mux/src/mp4.rs:236-287``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Optional, Tuple

import numpy as np

if TYPE_CHECKING:  # annotations only: the AAC codec process imports this
    # module for BitWriter and must not import torch
    from mixlab_tpu_torch.video.frame import Picture, PictureSettings


class BitWriter:
    """MSB-first bitstream writer with Exp-Golomb helpers."""

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def u(self, value: int, n: int):
        if n == 0:
            return
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def ue(self, value: int):
        # Exp-Golomb: (leading zeros) 1 (value+1 bits)
        v = value + 1
        n = v.bit_length()
        self.u(0, n - 1)
        self.u(v, n)

    def se(self, value: int):
        # signed mapping: 1->1, -1->2, 2->3, -2->4 ...
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def align_zero(self):
        if self.nbits:
            self.u(0, 8 - self.nbits)

    def bytes_aligned(self) -> bool:
        return self.nbits == 0

    def raw_bytes(self, data: bytes):
        assert self.nbits == 0, "raw bytes require alignment"
        self.buf += data

    def rbsp_trailing(self):
        self.u(1, 1)
        self.align_zero()

    def getvalue(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _ep_escape(rbsp: bytes) -> bytes:
    """Insert emulation-prevention 0x03 bytes (§7.4.1.1)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def nal(unit_type: int, rbsp: bytes, ref_idc: int = 3) -> bytes:
    return bytes([(ref_idc << 5) | unit_type]) + _ep_escape(rbsp)


# ---------------------------------------------------------------------------
# parameter sets
# ---------------------------------------------------------------------------


def make_sps(width: int, height: int, profile_idc: int = 66, level_idc: int = 40) -> bytes:
    """Sequence parameter set for a progressive 4:2:0 frame, pic_order_cnt
    type 2 (decode order == output order: intra-only streams)."""
    mbw = (width + 15) // 16
    mbh = (height + 15) // 16
    w = BitWriter()
    w.u(profile_idc, 8)
    # constraint_set0..2 + reserved: baseline-constrained
    w.u(0b11000000 if profile_idc == 66 else 0, 8)
    w.u(level_idc, 8)
    w.ue(0)  # seq_parameter_set_id
    w.ue(0)  # log2_max_frame_num_minus4 -> MaxFrameNum 16
    w.ue(2)  # pic_order_cnt_type
    w.ue(1)  # max_num_ref_frames
    w.u(0, 1)  # gaps_in_frame_num_value_allowed
    w.ue(mbw - 1)
    w.ue(mbh - 1)
    w.u(1, 1)  # frame_mbs_only_flag
    w.u(1, 1)  # direct_8x8_inference_flag
    crop_r = (mbw * 16 - width) // 2
    crop_b = (mbh * 16 - height) // 2
    if crop_r or crop_b:
        w.u(1, 1)
        w.ue(0)
        w.ue(crop_r)
        w.ue(0)
        w.ue(crop_b)
    else:
        w.u(0, 1)
    w.u(0, 1)  # vui_parameters_present
    w.rbsp_trailing()
    return w.getvalue()


def make_pps() -> bytes:
    w = BitWriter()
    w.ue(0)  # pic_parameter_set_id
    w.ue(0)  # seq_parameter_set_id
    w.u(0, 1)  # entropy_coding_mode (CAVLC)
    w.u(0, 1)  # bottom_field_pic_order_in_frame_present
    w.ue(0)  # num_slice_groups_minus1
    w.ue(0)  # num_ref_idx_l0_default_active_minus1
    w.ue(0)  # num_ref_idx_l1_default_active_minus1
    w.u(0, 1)  # weighted_pred_flag
    w.u(0, 2)  # weighted_bipred_idc
    w.se(0)  # pic_init_qp_minus26
    w.se(0)  # pic_init_qs_minus26
    w.se(0)  # chroma_qp_index_offset
    w.u(1, 1)  # deblocking_filter_control_present_flag
    w.u(0, 1)  # constrained_intra_pred_flag
    w.u(0, 1)  # redundant_pic_cnt_present_flag
    w.rbsp_trailing()
    return w.getvalue()


def _slice_header(w: BitWriter, qp_delta: int = 0, disable_deblocking: bool = True):
    """IDR I-slice header (§7.3.3): frame_num 0, POC type 2."""
    w.ue(0)  # first_mb_in_slice
    w.ue(7)  # slice_type: I (all slices)
    w.ue(0)  # pic_parameter_set_id
    w.u(0, 4)  # frame_num (log2_max_frame_num = 4)
    w.ue(0)  # idr_pic_id
    # dec_ref_pic_marking for IDR:
    w.u(0, 1)  # no_output_of_prior_pics_flag
    w.u(0, 1)  # long_term_reference_flag
    w.se(qp_delta)  # slice_qp_delta
    if disable_deblocking:
        w.ue(1)  # disable_deblocking_filter_idc = 1 (off)
    else:
        w.ue(0)
        w.se(0)
        w.se(0)


def _pad_planes(pic: Picture) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Edge-pad planes to macroblock multiples (torch planes are copied to
    the host first)."""
    planes = pic.to_numpy()
    y = np.asarray(planes["y"], dtype=np.uint8)
    u = np.asarray(planes["u"], dtype=np.uint8)
    v = np.asarray(planes["v"], dtype=np.uint8)
    h, wdt = y.shape
    mbw = (wdt + 15) // 16
    mbh = (h + 15) // 16
    py = np.pad(y, ((0, mbh * 16 - h), (0, mbw * 16 - wdt)), mode="edge")
    pu = np.pad(u, ((0, mbh * 8 - u.shape[0]), (0, mbw * 8 - u.shape[1])), mode="edge")
    pv = np.pad(v, ((0, mbh * 8 - v.shape[0]), (0, mbw * 8 - v.shape[1])), mode="edge")
    return py, pu, pv, mbw, mbh


# ---------------------------------------------------------------------------
# I_PCM encoder (lossless baseline)
# ---------------------------------------------------------------------------


def encode_frame_ipcm(pic: Picture) -> bytes:
    """One IDR picture, every macroblock I_PCM (§7.3.5: mb_type 25 in I
    slices).  Returns the slice NAL payload (unescaped RBSP)."""
    py, pu, pv, mbw, mbh = _pad_planes(pic)
    w = BitWriter()
    _slice_header(w)
    for my in range(mbh):
        for mx in range(mbw):
            w.ue(25)  # I_PCM
            w.align_zero()  # pcm_alignment_zero_bit
            w.raw_bytes(py[my * 16 : my * 16 + 16, mx * 16 : mx * 16 + 16].tobytes())
            w.raw_bytes(pu[my * 8 : my * 8 + 8, mx * 8 : mx * 8 + 8].tobytes())
            w.raw_bytes(pv[my * 8 : my * 8 + 8, mx * 8 : mx * 8 + 8].tobytes())
    w.rbsp_trailing()
    return w.getvalue()


# ---------------------------------------------------------------------------
# stream wrapper (FfmpegH264Stream-compatible)
# ---------------------------------------------------------------------------


class PureH264Stream:
    """Intra-only H.264 encoder with the codec-backend stream interface:
    ``feed(picture)`` then ``poll_access_units() -> [(is_key, avcc)]``;
    ``dcr`` carries the AVCDecoderConfigurationRecord once known.

    mode="cavlc" (default) = compressed intra; mode="ipcm" = lossless.
    """

    codec = "h264"

    def __init__(self, picture: PictureSettings, fps: int = 10,
                 profile: str = "monitor", mode: str = "cavlc", qp: int = 30):
        from mixlab_tpu_torch.av.avc import DecoderConfigurationRecord, NalUnit, UnitType

        self.picture = picture
        self.mode = mode
        self.qp = qp
        self.sps = make_sps(picture.width, picture.height)
        self.pps = make_pps()
        self.dcr = DecoderConfigurationRecord(
            1,
            self.sps[0],
            self.sps[1],
            self.sps[2],
            4,
            [NalUnit(3, UnitType.SEQUENCE_PARAMETER_SET, _ep_escape(self.sps))],
            [NalUnit(3, UnitType.PICTURE_PARAMETER_SET, _ep_escape(self.pps))],
        ).to_bytes()
        self._pending: List[Tuple[bool, bytes]] = []
        if mode == "cavlc":
            # fastest bit-exact tier: C++ full-frame encoder when the native
            # library loads, else the vectorized numpy two-pass encoder
            # (both byte-identical to the scalar CavlcIntraEncoder)
            from mixlab_tpu_torch.av.h264cavlc_fast import make_cavlc_encoder

            self._cavlc = make_cavlc_encoder(qp)

    def feed(self, pic: Picture):
        if self.mode == "ipcm":
            rbsp = encode_frame_ipcm(pic)
        else:
            rbsp = self._cavlc.encode_frame(pic)
        idr = nal(5, rbsp, ref_idc=3)
        self._pending.append((True, struct.pack(">I", len(idr)) + idr))

    def poll_access_units(self) -> List[Tuple[bool, bytes]]:
        out = self._pending
        self._pending = []
        return out

    # -- test/tooling helpers ------------------------------------------------

    def annexb(self, pic: Picture) -> bytes:
        """One self-contained Annex-B access unit (SPS+PPS+IDR), usable by
        independent decoders."""
        if self.mode == "ipcm":
            rbsp = encode_frame_ipcm(pic)
        else:
            rbsp = self._cavlc.encode_frame(pic)
        sc = b"\x00\x00\x00\x01"
        return (
            sc + nal(7, self.sps)
            + sc + nal(8, self.pps)
            + sc + nal(5, rbsp, ref_idc=3)
        )
