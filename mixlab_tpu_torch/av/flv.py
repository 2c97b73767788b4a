"""FLV AUDIODATA / VIDEODATA tag bodies (RTMP payloads).
(the port's copy of ``mixlab_tpu/av/flv.py``)

Byte-exact reimplementation of ``src/rtmp/packet.rs`` — parse/serialize the
FLV tag bodies RTMP carries (Adobe FLV spec E.4.2.1/E.4.3.1):

  audio: 0xAF (AAC, 44.1k stereo 16-bit) + packet type (0 = sequence
         header / ASC, 1 = raw AAC)
  video: frame-type<<4 | codec(7=AVC), packet type (0 = sequence header /
         DCR, 1 = NALU, 2 = end of sequence), BE24 composition time, data
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum


class FlvError(Exception):
    pass


# --- audio -----------------------------------------------------------------


@dataclass(frozen=True)
class AudioPacket:
    is_sequence_header: bool
    data: bytes

    TAG_AAC = 0xAF

    @staticmethod
    def parse(body: bytes) -> "AudioPacket":
        if len(body) < 2:
            raise FlvError("audio tag too short")
        tag = body[0]
        if tag != AudioPacket.TAG_AAC:
            raise FlvError(f"unsupported audio tag 0x{tag:02x}")
        packet_type = body[1]
        if packet_type == 0:
            return AudioPacket(True, bytes(body[2:]))
        if packet_type == 1:
            return AudioPacket(False, bytes(body[2:]))
        raise FlvError(f"bad AAC packet type {packet_type}")

    def to_bytes(self) -> bytes:
        return bytes([self.TAG_AAC, 0 if self.is_sequence_header else 1]) + self.data


def parse_audio_tag(body: bytes):
    """Parse an AUDIODATA tag body into ("aac_seq"|"aac_raw"|"pcm_s16le"|
    "mp3", payload).  Extends the reference's AAC-only parser with linear
    PCM (sound format 3) for codec-less loopback streaming and MP3 (sound
    format 2, what older RTMP encoders send)."""
    if len(body) < 2:
        raise FlvError("audio tag too short")
    sound_format = body[0] >> 4
    if sound_format == 10:  # AAC
        pkt = AudioPacket.parse(body)
        return ("aac_seq" if pkt.is_sequence_header else "aac_raw"), pkt.data
    if sound_format == 3:  # linear PCM little-endian
        return "pcm_s16le", bytes(body[1:])
    if sound_format == 2:  # MP3 (FLV SOUNDFORMAT 2)
        return "mp3", bytes(body[1:])
    raise FlvError(f"unsupported sound format {sound_format}")


def pcm_s16le_tag(data: bytes, sample_rate: int = 44100, stereo: bool = True) -> bytes:
    """AUDIODATA tag body for linear PCM little-endian (FLV sound format 3).

    Used by stream_output when no AAC encoder backend is available — a legal
    FLV payload the reference cannot produce (it requires fdk-aac)."""
    rate_idx = {5500: 0, 11025: 1, 22050: 2, 44100: 3}.get(sample_rate, 3)
    ident = (3 << 4) | (rate_idx << 2) | (1 << 1) | (1 if stereo else 0)
    return bytes([ident]) + data


# --- video -----------------------------------------------------------------


class VideoFrameType(IntEnum):
    KEY_FRAME = 1
    INTER_FRAME = 2
    DISPOSABLE_INTER_FRAME = 3
    GENERATED_KEY_FRAME = 4
    VIDEO_INFO_FRAME = 5


class VideoPacketType(IntEnum):
    SEQUENCE_HEADER = 0
    NALU = 1
    END_OF_SEQUENCE = 2


@dataclass(frozen=True)
class VideoPacket:
    frame_type: VideoFrameType
    packet_type: VideoPacketType
    composition_time: int  # BE24 ms
    data: bytes

    CODEC_AVC = 7

    @staticmethod
    def parse(body: bytes) -> "VideoPacket":
        if len(body) < 5:
            raise FlvError("video tag too short")
        ident = body[0]
        try:
            frame_type = VideoFrameType(ident >> 4)
        except ValueError:
            raise FlvError(f"bad frame type {ident >> 4}")
        if (ident & 0x0F) != VideoPacket.CODEC_AVC:
            raise FlvError(f"unsupported video codec {ident & 0x0F}")
        try:
            packet_type = VideoPacketType(body[1])
        except ValueError:
            raise FlvError(f"bad AVC packet type {body[1]}")
        composition_time = int.from_bytes(body[2:5], "big")
        return VideoPacket(frame_type, packet_type, composition_time, bytes(body[5:]))

    def to_bytes(self) -> bytes:
        out = bytearray()
        out.append((int(self.frame_type) << 4) | self.CODEC_AVC)
        out.append(int(self.packet_type))
        out += int(self.composition_time).to_bytes(3, "big")
        out += self.data
        return bytes(out)
