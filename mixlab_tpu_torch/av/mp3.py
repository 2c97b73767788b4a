"""MPEG audio (MP3/MP2/MP1) frame header parsing + stream splitter.
(the port's copy of ``mixlab_tpu/av/mp3.py``)

Icecast sources in the wild overwhelmingly send MP3; the reference rejects
them (lewton-only, ``src/icecast/mod.rs``).  This layer segments a raw
MPEG-audio byte stream into self-delimiting frames (the header encodes the
frame length) so each frame can be handed to a decoder as one packet: the
libavcodec shim's (``native/avshim.py``), in ``io_host/icecast.py`` and the
RTMP ingest.

Tables are the normative ISO/IEC 11172-3 / 13818-3 header fields.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple


class Mp3Error(ValueError):
    pass


# bitrate kbps by [version-group][layer][index]; version group 0 = MPEG1,
# 1 = MPEG2/2.5.  Index 0 is "free format" (unsupported), 15 invalid.
_BITRATES = {
    (0, 1): (0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352, 384, 416, 448),
    (0, 2): (0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384),
    (0, 3): (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320),
    (1, 1): (0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192, 224, 256),
    (1, 2): (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160),
    (1, 3): (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160),
}
_RATES = {
    3: (44100, 48000, 32000),   # MPEG1
    2: (22050, 24000, 16000),   # MPEG2
    0: (11025, 12000, 8000),    # MPEG2.5
}


@dataclass(frozen=True)
class Mp3FrameInfo:
    version_bits: int  # 3 = MPEG1, 2 = MPEG2, 0 = MPEG2.5
    layer: int  # 1, 2, 3
    bitrate: int  # bits/s
    sample_rate: int
    channels: int
    frame_length: int  # bytes, including the 4-byte header
    samples_per_frame: int


def parse_frame_header(data: bytes) -> Mp3FrameInfo:
    """Parse a 4-byte MPEG audio frame header; raises Mp3Error if invalid."""
    if len(data) < 4:
        raise Mp3Error("short header")
    b0, b1, b2, b3 = data[:4]
    if b0 != 0xFF or (b1 & 0xE0) != 0xE0:
        raise Mp3Error("no sync")
    version_bits = (b1 >> 3) & 0x03
    if version_bits == 1:
        raise Mp3Error("reserved version")
    layer_bits = (b1 >> 1) & 0x03
    if layer_bits == 0:
        raise Mp3Error("reserved layer (ADTS?)")
    layer = 4 - layer_bits  # 01 -> III, 10 -> II, 11 -> I
    bitrate_idx = (b2 >> 4) & 0x0F
    rate_idx = (b2 >> 2) & 0x03
    if bitrate_idx in (0, 15) or rate_idx == 3:
        raise Mp3Error("free-format/invalid bitrate or rate")
    vgroup = 0 if version_bits == 3 else 1
    bitrate = _BITRATES[(vgroup, layer)][bitrate_idx] * 1000
    sample_rate = _RATES[version_bits][rate_idx]
    padding = (b2 >> 1) & 1
    mode = (b3 >> 6) & 0x03
    channels = 1 if mode == 3 else 2
    if layer == 1:
        frame_length = (12 * bitrate // sample_rate + padding) * 4
        spf = 384
    else:
        spf = 1152 if (layer == 2 or vgroup == 0) else 576
        frame_length = spf // 8 * bitrate // sample_rate + padding
    if frame_length < 4:
        raise Mp3Error("degenerate frame length")
    return Mp3FrameInfo(version_bits, layer, bitrate, sample_rate, channels,
                        frame_length, spf)


def looks_like_mp3(data: bytes) -> bool:
    """Sniff: sync with a non-reserved layer (ADTS has layer bits 00)."""
    try:
        parse_frame_header(data)
        return True
    except Mp3Error:
        # ID3v2-tagged streams start with "ID3"
        return data[:3] == b"ID3"


class Mp3FrameSplitter:
    """Incremental splitter: feed bytes, get complete frames out.

    Resyncs on garbage (scans forward for the next plausible header) and
    skips a leading ID3v2 tag."""

    def __init__(self):
        self.buf = bytearray()
        self._id3_checked = False

    def feed(self, data: bytes) -> List[bytes]:
        self.buf += data
        out: List[bytes] = []
        if not self._id3_checked and len(self.buf) >= 10:
            if self.buf[:3] == b"ID3":
                size = ((self.buf[6] & 0x7F) << 21 | (self.buf[7] & 0x7F) << 14
                        | (self.buf[8] & 0x7F) << 7 | (self.buf[9] & 0x7F))
                total = 10 + size
                if len(self.buf) < total:
                    return out  # wait for the whole tag
                del self.buf[:total]
            self._id3_checked = True
        while True:
            if len(self.buf) < 4:
                return out
            try:
                info = parse_frame_header(bytes(self.buf[:4]))
            except Mp3Error:
                # resync: drop one byte, scan to the next 0xFF
                nxt = self.buf.find(0xFF, 1)
                del self.buf[: nxt if nxt > 0 else len(self.buf)]
                continue
            if len(self.buf) < info.frame_length:
                return out
            out.append(bytes(self.buf[: info.frame_length]))
            del self.buf[: info.frame_length]
