"""Ogg container parsing + Vorbis headers.

The port's copy of ``mixlab_tpu/av/ogg.py``.

Parity layer for the reference's ``codec/src/ogg.rs`` (lewton-based
Ogg/Vorbis audio stream with metadata comments): this module owns the
container — page framing (RFC 3533), packet reassembly across pages, CRC
checking — and the Vorbis identification/comment headers (sample rate,
channels, tags).  The Vorbis *DSP* (MDCT/floor/residue) is gated behind the
ffmpeg codec backend like the other compressed codecs (av/codecs.py); with
it absent, Icecast Ogg mounts are rejected with an informative error instead
of silently dropped.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple


class OggError(Exception):
    pass


# CRC-32 with polynomial 0x04C11DB7, no reflection, zero init/xorout (Ogg's
# variant differs from zlib.crc32)
_CRC_TABLE = []
for _i in range(256):
    _r = _i << 24
    for _ in range(8):
        _r = ((_r << 1) ^ 0x04C11DB7) if (_r & 0x80000000) else (_r << 1)
    _CRC_TABLE.append(_r & 0xFFFFFFFF)


def ogg_crc(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ _CRC_TABLE[((crc >> 24) & 0xFF) ^ b]
    return crc


@dataclass
class OggPage:
    version: int
    header_type: int  # 0x1 continued, 0x2 BOS, 0x4 EOS
    granule_position: int
    serial: int
    sequence: int
    segments: List[bytes]

    @property
    def is_bos(self) -> bool:
        return bool(self.header_type & 0x2)

    @property
    def is_eos(self) -> bool:
        return bool(self.header_type & 0x4)

    @property
    def continued(self) -> bool:
        return bool(self.header_type & 0x1)


class PageReader:
    """Incremental page parser over a byte stream (non-seekable-friendly,
    like the reference's reader, ogg.rs:55-130)."""

    def __init__(self, check_crc: bool = True):
        self.buf = bytearray()
        self.check_crc = check_crc

    def feed(self, data: bytes):
        self.buf += data

    def pages(self) -> Iterator[OggPage]:
        while True:
            page = self._try_parse()
            if page is None:
                return
            yield page

    def _try_parse(self) -> Optional[OggPage]:
        buf = self.buf
        idx = buf.find(b"OggS")
        if idx < 0:
            # keep a tail in case "Ogg" straddles the boundary
            del buf[:-3]
            return None
        if idx:
            del buf[:idx]
        if len(buf) < 27:
            return None
        (
            version,
            header_type,
            granule,
            serial,
            sequence,
            crc,
            n_segments,
        ) = struct.unpack_from("<BBqIIIB", buf, 4)
        header_len = 27 + n_segments
        if len(buf) < header_len:
            return None
        lacing = buf[27:header_len]
        body_len = sum(lacing)
        total = header_len + body_len
        if len(buf) < total:
            return None
        raw = bytes(buf[:total])
        del buf[:total]
        if self.check_crc:
            zeroed = raw[:22] + b"\x00\x00\x00\x00" + raw[26:]
            if ogg_crc(zeroed) != crc:
                raise OggError(f"page CRC mismatch (serial {serial} seq {sequence})")
        segments = []
        pos = header_len
        seg = bytearray()
        for lace in lacing:
            seg += raw[pos : pos + lace]
            pos += lace
            if lace < 255:
                segments.append((bytes(seg), True))
                seg = bytearray()
        if seg or (lacing and lacing[-1] == 255):
            segments.append((bytes(seg), False))  # continues on next page
        return OggPage(version, header_type, granule, serial, sequence, segments)


class PacketReader:
    """Reassembles packets (possibly spanning pages) per serial stream."""

    def __init__(self, check_crc: bool = True):
        self.pages = PageReader(check_crc)
        self._partial: Dict[int, bytearray] = {}

    def feed(self, data: bytes) -> List[Tuple[int, bytes]]:
        return [(serial, pkt) for serial, pkt, _, _ in self.feed_ex(data)]

    def feed_ex(self, data: bytes) -> List[Tuple[int, bytes, int, bool]]:
        """Like :meth:`feed` but each completed packet carries the granule
        position and EOS flag of the page it COMPLETED on — what a decoder
        needs for sample-exact end-of-stream truncation (RFC 3533 §6;
        the reference's lewton does the same internally)."""
        out = []
        self.pages.feed(data)
        for page in self.pages.pages():
            granule = page.granule_position
            eos = page.is_eos
            carry = self._partial.pop(page.serial, bytearray())
            for i, (seg, complete) in enumerate(page.segments):
                if i == 0 and page.continued:
                    carry += seg
                    if complete:
                        out.append((page.serial, bytes(carry), granule, eos))
                        carry = bytearray()
                    continue
                if carry:
                    out.append((page.serial, bytes(carry), granule, eos))
                    carry = bytearray()
                if complete:
                    out.append((page.serial, seg, granule, eos))
                else:
                    carry = bytearray(seg)
            if carry:
                self._partial[page.serial] = carry
        return out


# ---------------------------------------------------------------------------
# Vorbis headers (identification + comments)
# ---------------------------------------------------------------------------


@dataclass
class VorbisIdent:
    channels: int
    sample_rate: int
    bitrate_nominal: int


def parse_vorbis_ident(packet: bytes) -> VorbisIdent:
    if len(packet) < 30 or packet[0] != 1 or packet[1:7] != b"vorbis":
        raise OggError("not a Vorbis identification header")
    version, channels, rate = struct.unpack_from("<IBI", packet, 7)
    if version != 0:
        raise OggError(f"unsupported Vorbis version {version}")
    _max, nominal, _min = struct.unpack_from("<iii", packet, 16)
    return VorbisIdent(channels, rate, nominal)


def parse_vorbis_comments(packet: bytes) -> Dict[str, str]:
    """Metadata comments (the reference surfaces these: ogg.rs metadata)."""
    if len(packet) < 7 or packet[0] != 3 or packet[1:7] != b"vorbis":
        raise OggError("not a Vorbis comment header")
    pos = 7
    (vendor_len,) = struct.unpack_from("<I", packet, pos)
    pos += 4 + vendor_len
    (count,) = struct.unpack_from("<I", packet, pos)
    pos += 4
    tags = {}
    for _ in range(count):
        (n,) = struct.unpack_from("<I", packet, pos)
        pos += 4
        entry = packet[pos : pos + n].decode("utf-8", "replace")
        pos += n
        if "=" in entry:
            k, _, v = entry.partition("=")
            tags[k.upper()] = v
    return tags


# ---------------------------------------------------------------------------
# Ogg page writer (muxer) — TPU-build extension; the reference only reads
# Ogg (codec/src/ogg.rs), but a writer lets the test suite construct real
# Vorbis streams and completes the container layer.
# ---------------------------------------------------------------------------


def write_ogg_page(
    serial: int,
    sequence: int,
    granule: int,
    packets: List[bytes],
    bos: bool = False,
    eos: bool = False,
    continued: bool = False,
) -> bytes:
    """One page holding whole packets (each packet must be < 255*255 bytes
    unless it is the only one and continuation pages follow)."""
    lacing = bytearray()
    body = bytearray()
    for pkt in packets:
        n = len(pkt)
        while n >= 255:
            lacing.append(255)
            n -= 255
        lacing.append(n)
        body += pkt
    header_type = (0x1 if continued else 0) | (0x2 if bos else 0) | (0x4 if eos else 0)
    head = b"OggS" + struct.pack(
        "<BBqIIIB",
        0,
        header_type,
        granule,
        serial & 0xFFFFFFFF,
        sequence,
        0,  # CRC placeholder
        len(lacing),
    ) + bytes(lacing)
    raw = head + bytes(body)
    crc = ogg_crc(raw)
    return raw[:22] + struct.pack("<I", crc) + raw[26:]


def write_ogg_stream(packets_with_granules, serial: int = 0x6D69786C) -> bytes:
    """Mux (packet, granule) pairs into a single-logical-stream Ogg byte
    string.  Packets larger than 255 lacing segments span pages with the
    'continued' flag (RFC 3533 framing); a page's granule is that of the
    last packet COMPLETED on it (-1 when none)."""
    out = bytearray()
    seq = 0
    items = list(packets_with_granules)

    def emit(lacing, body, granule, bos, eos, continued):
        nonlocal seq, out
        header_type = (0x1 if continued else 0) | (0x2 if bos else 0) | (0x4 if eos else 0)
        head = b"OggS" + struct.pack(
            "<BBqIIIB", 0, header_type, granule, serial & 0xFFFFFFFF, seq, 0,
            len(lacing),
        ) + bytes(lacing)
        raw = head + bytes(body)
        crc = ogg_crc(raw)
        out += raw[:22] + struct.pack("<I", crc) + raw[26:]
        seq += 1

    lacing = bytearray()
    body = bytearray()
    page_granule = -1
    continued = False
    first_page = True

    def flush(eos=False):
        nonlocal lacing, body, page_granule, continued, first_page
        emit(lacing, body, page_granule, first_page, eos, continued)
        lacing = bytearray()
        body = bytearray()
        page_granule = -1
        first_page = False
        continued = False

    for idx, (pkt, granule) in enumerate(items):
        pos = 0
        n = len(pkt)
        while True:
            # fill this page with as much of the packet as fits
            while len(lacing) < 255:
                take = min(255, n - pos)
                lacing.append(take)
                body += pkt[pos : pos + take]
                pos += take
                if take < 255:
                    break  # packet completed on this page
            completed = pos >= n and (len(lacing) == 0 or lacing[-1] < 255)
            if completed:
                page_granule = granule
                # headers (granule 0 markers) get their own page boundary:
                # BOS page carries only the first packet (Vorbis mandates it)
                if idx == 0 or idx == len(items) - 1 or len(lacing) >= 255:
                    flush(eos=(idx == len(items) - 1))
                break
            # page full mid-packet: flush and continue the packet
            flush()
            continued = True
    if lacing:
        flush(eos=True)
    return bytes(out)


def parse_xiph_extradata(extradata: bytes) -> List[bytes]:
    """libavcodec-style xiph extradata -> the three Vorbis header packets."""
    if not extradata or extradata[0] != 2:
        raise OggError("not xiph-laced extradata")
    pos = 1
    sizes = []
    for _ in range(2):
        n = 0
        while True:
            b = extradata[pos]
            pos += 1
            n += b
            if b < 255:
                break
        sizes.append(n)
    out = []
    for n in sizes:
        out.append(extradata[pos : pos + n])
        pos += n
    out.append(extradata[pos:])
    return out
