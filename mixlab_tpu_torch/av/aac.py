"""AAC bitstream structures: AudioSpecificConfiguration + ADTS framing.
(the port's copy of ``mixlab_tpu/av/aac.py``)

Byte-exact reimplementation of the reference's pure-Rust AAC layer:
  * ASC 2-byte parse — ``codec/src/aac/config.rs:58-81``
  * ADTS 7-byte header synthesis — ``codec/src/aac/adts.rs:62-111``
    (validated against the reference's own unit-test vector,
    adts.rs:113-141, reproduced in tests/test_av_bitstream.py)

Layout (ADTS, protection absent):
  12 sync | 1 mpeg-version | 2 layer | 1 prot-absent |
  2 profile | 4 sfi | 1 private | 3 channels |
  1 orig | 1 home | 1 cid | 1 cid-start | 13 frame-len |
  11 buffer-fullness | 2 frames-minus-one
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum


class AacError(Exception):
    pass


class AudioObjectType(IntEnum):
    MAIN = 1
    LOW_COMPLEXITY = 2
    SCALABLE_SAMPLE_RATE = 3
    LONG_TERM_PREDICTION = 4


SAMPLING_FREQUENCIES = [
    96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
    16000, 12000, 11025, 8000, 7350,
]


def sampling_frequency_index(rate: int) -> int:
    try:
        return SAMPLING_FREQUENCIES.index(rate)
    except ValueError:
        raise AacError(f"unsupported sample rate {rate}")


@dataclass(frozen=True)
class AudioSpecificConfiguration:
    object_type: AudioObjectType
    sampling_frequency_index: int
    channel_configuration: int
    frame_length_flag: bool = False
    depends_on_core_coder: bool = False
    extension_flag: bool = False

    @staticmethod
    def parse(data: bytes) -> "AudioSpecificConfiguration":
        if len(data) < 2:
            raise AacError("ASC too short")
        x, y = data[0], data[1]
        ot = (x & 0xF8) >> 3
        if not 1 <= ot <= 4:
            raise AacError(f"unsupported audio object type {ot}")
        sfi = ((x & 0x07) << 1) | (y >> 7)
        # 13/14 reserved; 15 = escape (24-bit explicit rate follows, which
        # this 2-byte parser does not carry).  Reject with a typed error so
        # hostile ASCs can never index past SAMPLING_FREQUENCIES downstream.
        if sfi >= len(SAMPLING_FREQUENCIES):
            raise AacError(f"unsupported sampling frequency index {sfi}")
        return AudioSpecificConfiguration(
            object_type=AudioObjectType(ot),
            sampling_frequency_index=sfi,
            channel_configuration=(y >> 3) & 0x0F,
            frame_length_flag=bool(y & 0x04),
            depends_on_core_coder=bool(y & 0x02),
            extension_flag=bool(y & 0x01),
        )

    def to_bytes(self) -> bytes:
        x = ((int(self.object_type) & 0x1F) << 3) | (
            (self.sampling_frequency_index >> 1) & 0x07
        )
        y = (
            ((self.sampling_frequency_index & 0x01) << 7)
            | ((self.channel_configuration & 0x0F) << 3)
            | (0x04 if self.frame_length_flag else 0)
            | (0x02 if self.depends_on_core_coder else 0)
            | (0x01 if self.extension_flag else 0)
        )
        return bytes([x, y])

    @staticmethod
    def lc_stereo(rate: int = 44100) -> "AudioSpecificConfiguration":
        return AudioSpecificConfiguration(
            AudioObjectType.LOW_COMPLEXITY, sampling_frequency_index(rate), 2
        )


def adts_frame(payload: bytes, asc: AudioSpecificConfiguration) -> bytes:
    """Wrap one raw AAC frame in a 7-byte ADTS header (MPEG-4, no CRC)."""
    if len(payload) > (0xFFFF & 0x1FFF):
        raise AacError("payload too large for ADTS frame length field")
    profile = int(asc.object_type) - 1
    sfi = asc.sampling_frequency_index
    if sfi == 0x0F:
        raise AacError("sampling frequency index 15 forbidden")
    chan = asc.channel_configuration
    frame_length = len(payload) + 7

    hdr = bytearray(7)
    # sync(12)=0xFFF, version(1)=0 mpeg4, layer(2)=0, protection-absent(1)=1
    hdr[0] = 0xFF
    hdr[1] = 0xF0 | 0x01
    hdr[2] = (profile << 6) | (sfi << 2) | ((chan & 0x07) >> 2)
    hdr[3] = ((chan & 0x03) << 6) | ((frame_length >> 11) & 0x03)
    hdr[4] = (frame_length >> 3) & 0xFF
    hdr[5] = ((frame_length & 0x07) << 5) | 0x1F  # buffer fullness = all ones
    hdr[6] = 0xFC  # fullness cont. | frames-minus-one = 0
    return bytes(hdr) + payload


def strip_adts_header(frame: bytes) -> bytes:
    """Remove the 7-byte ADTS header (mux path, mux/src/mp4.rs:236)."""
    if len(frame) < 7 or frame[0] != 0xFF or (frame[1] & 0xF0) != 0xF0:
        raise AacError("not an ADTS frame")
    has_crc = (frame[1] & 0x01) == 0
    return frame[9:] if has_crc else frame[7:]


def parse_adts_header(frame: bytes) -> dict:
    if len(frame) < 7:
        raise AacError("short ADTS header")
    if frame[0] != 0xFF or (frame[1] & 0xF0) != 0xF0:
        raise AacError("bad ADTS sync")
    return {
        "mpeg_version": (frame[1] >> 3) & 1,
        "protection_absent": frame[1] & 1,
        "profile": (frame[2] >> 6) & 0x03,
        "sampling_frequency_index": (frame[2] >> 2) & 0x0F,
        "channel_configuration": ((frame[2] & 0x01) << 2) | (frame[3] >> 6),
        "frame_length": ((frame[3] & 0x03) << 11) | (frame[4] << 3) | (frame[5] >> 5),
    }
