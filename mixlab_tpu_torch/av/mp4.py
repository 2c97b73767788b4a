"""Fragmented MP4 (fMP4) muxer for MSE streaming.
(the port's copy of ``mixlab_tpu/av/mp4.py``)

Functional rebuild of the reference mux crate (``mux/src/mp4.rs``): an init
segment (ftyp + moov with AAC and AVC sample entries and mvex/trex) followed
by one-sample media segments (moof/tfhd/tfdt/trun + mdat).  The reference
delegated box serialization to the ``mse_fmp4`` crate; here the ISO/IEC
14496-12 boxes are written directly.

Reference behaviours preserved:
  * one sample per fragment, alternating tracks as the caller chooses
  * rational->timescale rounding with carried remainder: fragment duration
    is end_in_base - start_in_base of exact rational times (mp4.rs:238-242)
  * 7-byte ADTS header stripped from audio frames (mp4.rs:236)
  * video sample flags: depends_on=1, non-sync unless key frame
    (mp4.rs:276-287)
  * trun data_offset = moof size + 8 (mdat header) (mp4.rs:340-344)
  * track durations: tkhd 0xFFFFFFFF ("cannot be determined"), mvhd 0
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

from mixlab_tpu_torch.av.aac import AudioSpecificConfiguration, strip_adts_header
from mixlab_tpu_torch.utils.mtime import MediaDuration, MediaTime

AUDIO_TRACK = 1
VIDEO_TRACK = 2


def box(kind: bytes, *payloads: bytes) -> bytes:
    body = b"".join(payloads)
    return struct.pack(">I", 8 + len(body)) + kind + body


def full_box(kind: bytes, version: int, flags: int, *payloads: bytes) -> bytes:
    return box(kind, struct.pack(">I", (version << 24) | flags), *payloads)


_UNITY_MATRIX = struct.pack(
    ">9i", 0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0, 0x40000000
)


# ---------------------------------------------------------------------------
# sample descriptions
# ---------------------------------------------------------------------------


def _descriptor(tag: int, body: bytes) -> bytes:
    # simple one-byte expandable length (all our descriptors are < 128 B)
    assert len(body) < 128
    return bytes([tag, len(body)]) + body


def _esds(asc: bytes) -> bytes:
    dec_specific = _descriptor(0x05, asc)
    dec_config = _descriptor(
        0x04,
        bytes([0x40, 0x15])  # MPEG-4 audio, audio stream
        + b"\x00\x00\x00"  # bufferSizeDB
        + struct.pack(">II", 0, 0)  # max/avg bitrate
        + dec_specific,
    )
    sl_config = _descriptor(0x06, b"\x02")
    es = _descriptor(
        0x03, struct.pack(">HB", 0, 0) + dec_config + sl_config
    )
    return full_box(b"esds", 0, 0, es)


def _mp4a_entry(sample_rate: int, channels: int, asc: bytes) -> bytes:
    body = (
        b"\x00" * 6
        + struct.pack(">H", 1)  # data_reference_index
        + b"\x00" * 8  # reserved
        + struct.pack(">HHHH", channels, 16, 0, 0)
        + struct.pack(">I", sample_rate << 16)
        + _esds(asc)
    )
    return box(b"mp4a", body)


def _flac_entry(sample_rate: int, channels: int, streaminfo_block: bytes) -> bytes:
    """FLAC-in-ISO-BMFF sample entry (encapsulation spec: 'fLaC' audio
    sample entry + 'dfLa' box carrying the STREAMINFO metadata block).
    Used by the pure zero-dependency monitor tier (av/flacenc.py);
    browsers accept it via MSE as codecs="flac"."""
    dfla = full_box(b"dfLa", 0, 0, streaminfo_block)
    body = (
        b"\x00" * 6
        + struct.pack(">H", 1)  # data_reference_index
        + b"\x00" * 8  # reserved
        + struct.pack(">HHHH", channels, 16, 0, 0)
        + struct.pack(">I", sample_rate << 16)
        + dfla
    )
    return box(b"fLaC", body)


def _avc1_entry(width: int, height: int, dcr: bytes) -> bytes:
    body = (
        b"\x00" * 6
        + struct.pack(">H", 1)  # data_reference_index
        + struct.pack(">HH", 0, 0)  # pre_defined, reserved
        + b"\x00" * 12  # pre_defined[3]
        + struct.pack(">HH", width, height)
        + struct.pack(">II", 0x00480000, 0x00480000)  # 72 dpi
        + struct.pack(">I", 0)
        + struct.pack(">H", 1)  # frame_count
        + b"\x00" * 32  # compressorname
        + struct.pack(">Hh", 0x0018, -1)
        + box(b"avcC", dcr)
    )
    return box(b"avc1", body)


# ---------------------------------------------------------------------------
# init segment
# ---------------------------------------------------------------------------


def _empty_stbl_tail() -> bytes:
    return (
        full_box(b"stts", 0, 0, struct.pack(">I", 0))
        + full_box(b"stsc", 0, 0, struct.pack(">I", 0))
        + full_box(b"stsz", 0, 0, struct.pack(">II", 0, 0))
        + full_box(b"stco", 0, 0, struct.pack(">I", 0))
    )


def _dinf() -> bytes:
    url = full_box(b"url ", 0, 1)  # self-contained
    dref = full_box(b"dref", 0, 0, struct.pack(">I", 1) + url)
    return box(b"dinf", dref)


def _tkhd(track_id: int, width: int, height: int, volume: int) -> bytes:
    return full_box(
        b"tkhd",
        0,
        7,  # enabled | in_movie | in_preview
        struct.pack(">II", 0, 0),  # creation, modification
        struct.pack(">I", track_id),
        struct.pack(">I", 0),  # reserved
        struct.pack(">I", 0xFFFFFFFF),  # duration unknown (mp4.rs:107-111)
        b"\x00" * 8,
        struct.pack(">hhHH", 0, 0, volume, 0),
        _UNITY_MATRIX,
        struct.pack(">II", width << 16, height << 16),
    )


def _mdia(timescale: int, handler: bytes, name: bytes, minf_head: bytes, stsd_entry: bytes) -> bytes:
    mdhd = full_box(
        b"mdhd",
        0,
        0,
        struct.pack(">IIIIHH", 0, 0, timescale, 0, 0x55C4, 0),  # lang "und"
    )
    hdlr = full_box(
        b"hdlr", 0, 0, struct.pack(">I", 0) + handler + b"\x00" * 12 + name + b"\x00"
    )
    stsd = full_box(b"stsd", 0, 0, struct.pack(">I", 1) + stsd_entry)
    stbl = box(b"stbl", stsd + _empty_stbl_tail())
    minf = box(b"minf", minf_head + _dinf() + stbl)
    return box(b"mdia", mdhd + hdlr + minf)


def _trex(track_id: int) -> bytes:
    return full_box(b"trex", 0, 0, struct.pack(">IIIII", track_id, 1, 0, 0, 0))


@dataclass(frozen=True)
class Mp4Params:
    timescale: int
    width: int
    height: int
    dcr: bytes  # raw AVCDecoderConfigurationRecord
    sample_rate: int = 44100
    channels: int = 2
    audio_codec: str = "aac"  # "aac" | "flac" (pure tier, av/flacenc.py)
    flac_streaminfo_block: bytes = b""  # dfLa payload when audio_codec=flac


def make_init_segment(params: Mp4Params) -> bytes:
    ftyp = box(b"ftyp", b"isom", struct.pack(">I", 512), b"isom", b"iso5", b"avc1", b"mp41")
    mvhd = full_box(
        b"mvhd",
        0,
        0,
        struct.pack(">IIII", 0, 0, params.timescale, 0),
        struct.pack(">IHH", 0x00010000, 0x0100, 0),
        b"\x00" * 8,
        _UNITY_MATRIX,
        b"\x00" * 24,
        struct.pack(">I", 0xFFFFFFFF),  # next_track_ID
    )
    if params.audio_codec == "flac":
        audio_entry = _flac_entry(
            params.sample_rate, params.channels, params.flac_streaminfo_block
        )
    else:
        asc = AudioSpecificConfiguration.lc_stereo(params.sample_rate).to_bytes()
        audio_entry = _mp4a_entry(params.sample_rate, params.channels, asc)
    audio_trak = box(
        b"trak",
        _tkhd(AUDIO_TRACK, 0, 0, 0x0100),
        _mdia(
            params.timescale,
            b"soun",
            b"Mixlab-TPU Audio",
            full_box(b"smhd", 0, 0, struct.pack(">HH", 0, 0)),
            audio_entry,
        ),
    )
    video_trak = box(
        b"trak",
        _tkhd(VIDEO_TRACK, params.width, params.height, 0x0100),
        _mdia(
            params.timescale,
            b"vide",
            b"Mixlab-TPU Video",
            full_box(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0)),
            _avc1_entry(params.width, params.height, params.dcr),
        ),
    )
    mvex = box(b"mvex", _trex(AUDIO_TRACK) + _trex(VIDEO_TRACK))
    moov = box(b"moov", mvhd + audio_trak + video_trak + mvex)
    return ftyp + moov


# ---------------------------------------------------------------------------
# media segments
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AdtsFrame:
    data: bytes  # ADTS-framed AAC


@dataclass(frozen=True)
class FlacFrame:
    data: bytes  # one complete FLAC frame (header..CRC-16), stored verbatim


@dataclass(frozen=True)
class AvcFrame:
    is_key_frame: bool
    composition_time: MediaDuration
    data: bytes  # length-prefixed NALUs


TrackData = Union[AdtsFrame, FlacFrame, AvcFrame]


def _sample_flags(is_key: bool) -> int:
    depends_on = 1  # other samples depend on this (mp4.rs:276-287)
    non_sync = 0 if is_key else 1
    return (depends_on << 24) | (non_sync << 16)


class Mp4Mux:
    """Stateful fragment muxer (mux/src/mp4.rs:48-67)."""

    def __init__(self, params: Mp4Params):
        self.params = params
        self.sequence = 0
        self.audio_time = MediaTime.zero()
        self.video_time = MediaTime.zero()

    @classmethod
    def create(cls, params: Mp4Params) -> Tuple["Mp4Mux", bytes]:
        mux = cls(params)
        return mux, make_init_segment(params)

    def write_track(self, duration: MediaDuration, data: TrackData) -> bytes:
        ts = self.params.timescale
        if isinstance(data, (AdtsFrame, FlacFrame)):
            payload = (
                strip_adts_header(data.data)
                if isinstance(data, AdtsFrame)
                else data.data
            )
            start = self.audio_time.round_to_base(ts)
            end_time = self.audio_time + duration
            end = end_time.round_to_base(ts)
            self.audio_time = end_time
            track_id = AUDIO_TRACK
            sample_tail = struct.pack(">II", end - start, len(payload))
            trun_flags = 0x000001 | 0x000100 | 0x000200
        else:
            payload = data.data
            start = self.video_time.round_to_base(ts)
            end_time = self.video_time + duration
            end = end_time.round_to_base(ts)
            self.video_time = end_time
            track_id = VIDEO_TRACK
            cts = data.composition_time.round_to_base(ts)
            sample_tail = struct.pack(
                ">IIIi", end - start, len(payload), _sample_flags(data.is_key_frame), cts
            )
            trun_flags = 0x000001 | 0x000100 | 0x000200 | 0x000400 | 0x000800

        self.sequence += 1
        mfhd = full_box(b"mfhd", 0, 0, struct.pack(">I", self.sequence))
        tfhd = full_box(b"tfhd", 0, 0x020000, struct.pack(">I", track_id))
        tfdt = full_box(b"tfdt", 0, 0, struct.pack(">I", start & 0xFFFFFFFF))

        def trun(data_offset: int) -> bytes:
            return full_box(
                b"trun",
                1 if track_id == VIDEO_TRACK else 0,
                trun_flags,
                struct.pack(">Ii", 1, data_offset),
                sample_tail,
            )

        traf = box(b"traf", tfhd + tfdt + trun(0))
        moof = box(b"moof", mfhd + traf)
        # patch data_offset: moof size + 8-byte mdat header (mp4.rs:340-344)
        traf = box(b"traf", tfhd + tfdt + trun(len(moof) + 8))
        moof = box(b"moof", mfhd + traf)
        mdat = box(b"mdat", payload)
        return moof + mdat
