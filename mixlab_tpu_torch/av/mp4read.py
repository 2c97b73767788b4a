"""Pure MP4/ISO-BMFF demuxer (no libavformat).

The port's copy of ``mixlab_tpu/av/mp4read.py``.

Read-side counterpart of the from-scratch muxer (``av/mp4.py``): parses
both PROGRESSIVE files (``moov`` sample tables: stsd/stts/ctts/stsc/stsz/
stco/co64/stss) and FRAGMENTED streams (``moov``+``mvex`` defaults, then
``moof``/``traf``: tfhd/tfdt/trun — including the one-sample
default-base-is-moof fragments our own mux emits), yielding per-track
sample runs with absolute byte offsets, decode/composition times, and
keyframe flags.

Closes the capability the reference gets from libavformat's demuxer
(``codec/src/ffmpeg/format.rs:16-144``): on a codec-less image, MP4 media
uploads demux here and decode through the pure tiers (CAVLC H.264 video
``av/h264dec.py``, FLAC audio ``av/flacdec.py``, AAC-LC audio
``av/aacdec.py``); out-of-scope shapes raise typed errors, never
mis-decode.

Codec payload conventions (what ``Sample.data`` contains):
  * ``h264`` — length-prefixed NALUs; ``TrackInfo.dcr`` carries the raw
    AVCDecoderConfigurationRecord from ``avcC`` (length size inside).
  * ``aac``  — raw AAC access units; ``TrackInfo.asc`` from ``esds``.
  * ``flac`` — whole FLAC frames; ``TrackInfo.streaminfo`` = 34-byte
    STREAMINFO from ``dfLa``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple


class Mp4Error(Exception):
    pass


# sanity cap on any declared entry/sample count: a corrupt 32-bit count
# field must not become a multi-GB allocation (adversarial uploads)
_MAX_ENTRIES = 1 << 24


def _check_count(n: int, what: str) -> int:
    if n < 0 or n > _MAX_ENTRIES:
        raise Mp4Error(f"unreasonable {what} count {n}")
    return n


def _boxes4(data: bytes, start: int, end: int
            ) -> Iterator[Tuple[bytes, int, int, int]]:
    """Yield (fourcc, payload_start, payload_end, box_start) for boxes in
    [start, end) — box_start is largesize-aware (the moof anchor needs it)."""
    at = start
    while at + 8 <= end:
        size = struct.unpack_from(">I", data, at)[0]
        kind = data[at + 4 : at + 8]
        head = 8
        if size == 1:
            if at + 16 > end:
                raise Mp4Error("truncated largesize box")
            size = struct.unpack_from(">Q", data, at + 8)[0]
            head = 16
        elif size == 0:  # to end of enclosing container
            size = end - at
        if size < head or at + size > end:
            raise Mp4Error(f"bad box size {size} for {kind!r}")
        yield kind, at + head, at + size, at
        at += size


def _boxes(data: bytes, start: int, end: int) -> Iterator[Tuple[bytes, int, int]]:
    """Yield (fourcc, payload_start, payload_end) for boxes in [start, end)."""
    for kind, s, e, _ in _boxes4(data, start, end):
        yield kind, s, e


def _find(data: bytes, start: int, end: int, kind: bytes) -> Optional[Tuple[int, int]]:
    for k, s, e in _boxes(data, start, end):
        if k == kind:
            return s, e
    return None


def _full(data: bytes, s: int) -> Tuple[int, int, int]:
    """(version, flags, payload_start) of a full box at payload offset s."""
    vf = struct.unpack_from(">I", data, s)[0]
    return vf >> 24, vf & 0xFFFFFF, s + 4


@dataclass
class Sample:
    offset: int  # absolute into the file
    size: int
    dts: int  # in track timescale units
    cts_offset: int = 0  # composition offset (signed)
    key: bool = True

    @property
    def cts(self) -> int:
        return self.dts + self.cts_offset


@dataclass
class TrackInfo:
    track_id: int
    handler: str  # "soun" / "vide" / other
    codec: str  # "h264" / "aac" / "flac" / fourcc
    timescale: int
    width: int = 0
    height: int = 0
    channels: int = 0
    sample_rate: int = 0
    dcr: bytes = b""  # raw AVCDecoderConfigurationRecord (h264)
    asc: bytes = b""  # AudioSpecificConfiguration (aac)
    streaminfo: bytes = b""  # 34-byte STREAMINFO (flac)
    edit_media_time: int = 0  # elst media_time (leading-media skip)
    samples: List[Sample] = field(default_factory=list)
    # mvex/trex fragment defaults
    default_duration: int = 0
    default_size: int = 0
    default_flags: int = 0


def _parse_esds_asc(data: bytes, s: int, e: int) -> bytes:
    """Extract the DecoderSpecificInfo (tag 0x05) from an esds payload."""
    at = s
    while at < e:
        tag = data[at]
        at += 1
        # expandable length
        length = 0
        while at < e:
            b = data[at]
            at += 1
            length = (length << 7) | (b & 0x7F)
            if not b & 0x80:
                break
        if tag == 0x05:
            return bytes(data[at : at + length])
        if tag in (0x03, 0x04):  # descend into ES / DecoderConfig
            if tag == 0x03:
                at += 3  # ES_ID + flags
            else:
                at += 13  # objectType .. avg bitrate
            continue
        at += length
    return b""


def _parse_stsd_entry(data: bytes, s: int, e: int, t: TrackInfo):
    for kind, es, ee in _boxes(data, s, e):
        t.codec = kind.decode("latin1").strip()
        if kind == b"avc1":
            t.codec = "h264"
            t.width, t.height = struct.unpack_from(">HH", data, es + 24)
            sub = _find(data, es + 78, ee, b"avcC")
            if sub is None:
                raise Mp4Error("avc1 without avcC")
            t.dcr = bytes(data[sub[0] : sub[1]])
        elif kind in (b"mp4a", b"fLaC"):
            t.channels, _bits = struct.unpack_from(">HH", data, es + 16)
            t.sample_rate = struct.unpack_from(">I", data, es + 24)[0] >> 16
            if kind == b"mp4a":
                t.codec = "aac"
                sub = _find(data, es + 28, ee, b"esds")
                if sub is not None:
                    _, _, ps = _full(data, sub[0])
                    t.asc = _parse_esds_asc(data, ps, sub[1])
            else:
                t.codec = "flac"
                sub = _find(data, es + 28, ee, b"dfLa")
                if sub is not None:
                    _, _, ps = _full(data, sub[0])
                    blocks = bytes(data[ps : sub[1]])
                    # dfLa carries metadata blocks (4-byte header each) or,
                    # from our own mux, a bare 34-byte STREAMINFO
                    if len(blocks) >= 38 and (blocks[0] & 0x7F) == 0:
                        t.streaminfo = blocks[4:38]
                    else:
                        t.streaminfo = blocks[:34]
        return  # first entry only (sample_description_index 1)


def _u32s(data: bytes, s: int, n: int) -> Tuple[int, ...]:
    return struct.unpack_from(f">{n}I", data, s)


def _parse_stbl(data: bytes, s: int, e: int, t: TrackInfo):
    stts: List[Tuple[int, int]] = []
    ctts: List[Tuple[int, int]] = []
    stsc: List[Tuple[int, int, int]] = []
    sizes: List[int] = []
    chunk_offsets: List[int] = []
    sync: Optional[set] = None
    for kind, bs, be in _boxes(data, s, e):
        if kind == b"stsd":
            _, _, ps = _full(data, bs)
            (_count,) = struct.unpack_from(">I", data, ps)
            _parse_stsd_entry(data, ps + 4, be, t)
        elif kind == b"stts":
            _, _, ps = _full(data, bs)
            n = _check_count(struct.unpack_from(">I", data, ps)[0], "stts")
            vals = _u32s(data, ps + 4, 2 * n)
            stts = [(vals[2 * i], vals[2 * i + 1]) for i in range(n)]
        elif kind == b"ctts":
            ver, _, ps = _full(data, bs)
            n = _check_count(struct.unpack_from(">I", data, ps)[0], "ctts")
            for i in range(n):
                cnt = struct.unpack_from(">I", data, ps + 4 + 8 * i)[0]
                off = struct.unpack_from(
                    ">i" if ver == 1 else ">I", data, ps + 8 + 8 * i)[0]
                ctts.append((cnt, off))
        elif kind == b"stsc":
            _, _, ps = _full(data, bs)
            n = _check_count(struct.unpack_from(">I", data, ps)[0], "stsc")
            vals = _u32s(data, ps + 4, 3 * n)
            stsc = [tuple(vals[3 * i : 3 * i + 3]) for i in range(n)]
        elif kind == b"stsz":
            _, _, ps = _full(data, bs)
            uniform, n = struct.unpack_from(">II", data, ps)
            _check_count(n, "stsz")
            sizes = [uniform] * n if uniform else list(_u32s(data, ps + 8, n))
        elif kind in (b"stco", b"co64"):
            _, _, ps = _full(data, bs)
            n = _check_count(struct.unpack_from(">I", data, ps)[0], "stco")
            if kind == b"stco":
                chunk_offsets = list(_u32s(data, ps + 4, n))
            else:
                chunk_offsets = list(struct.unpack_from(f">{n}Q", data, ps + 4))
        elif kind == b"stss":
            _, _, ps = _full(data, bs)
            n = _check_count(struct.unpack_from(">I", data, ps)[0], "stss")
            sync = set(_u32s(data, ps + 4, n))

    if not sizes:
        return  # fragmented: tables are empty in the init moov

    # per-sample dts from stts run lengths
    dts_list: List[int] = []
    tdts = 0
    for count, delta in stts:
        _check_count(len(dts_list) + count, "stts expansion")
        for _ in range(count):
            dts_list.append(tdts)
            tdts += delta
    # composition offsets
    cts_list: List[int] = []
    for count, off in ctts:
        _check_count(len(cts_list) + count, "ctts expansion")
        cts_list.extend([off] * count)
    # chunk map: stsc runs give samples-per-chunk from each first_chunk on
    n_chunks = len(chunk_offsets)
    spc = [0] * n_chunks
    for i, (first, per, _desc) in enumerate(stsc):
        last = stsc[i + 1][0] - 1 if i + 1 < len(stsc) else n_chunks
        for c in range(first - 1, last):
            if 0 <= c < n_chunks:
                spc[c] = per
    si = 0
    for c in range(n_chunks):
        at = chunk_offsets[c]
        for _ in range(spc[c]):
            if si >= len(sizes):
                break
            t.samples.append(Sample(
                offset=at,
                size=sizes[si],
                dts=dts_list[si] if si < len(dts_list) else 0,
                cts_offset=cts_list[si] if si < len(cts_list) else 0,
                key=(sync is None or (si + 1) in sync),
            ))
            at += sizes[si]
            si += 1


# trun/tfhd flag bits
_TFHD_BASE_OFFSET = 0x000001
_TFHD_DESC_INDEX = 0x000002
_TFHD_DEF_DURATION = 0x000008
_TFHD_DEF_SIZE = 0x000010
_TFHD_DEF_FLAGS = 0x000020
_TFHD_BASE_IS_MOOF = 0x020000
_TRUN_DATA_OFFSET = 0x000001
_TRUN_FIRST_FLAGS = 0x000004
_TRUN_DURATION = 0x000100
_TRUN_SIZE = 0x000200
_TRUN_FLAGS = 0x000400
_TRUN_CTS = 0x000800

_NON_SYNC_BIT = 0x00010000


class Mp4Reader:
    """Parse a whole MP4 byte string (progressive file, or an init segment
    followed by any number of media segments — e.g. the concatenation of a
    monitor stream's fMP4 packets)."""

    def __init__(self, data: bytes):
        self.data = data
        self.tracks: Dict[int, TrackInfo] = {}
        try:
            moov = _find(data, 0, len(data), b"moov")
            if moov is None:
                raise Mp4Error("no moov box")
            self._parse_moov(*moov)
            self._parse_fragments()
        except Mp4Error:
            raise
        except (struct.error, IndexError, AttributeError, TypeError) as e:
            # adversarial input discipline (tests/test_codec_fuzz.py):
            # truncated/corrupt tables surface as the typed error
            raise Mp4Error(f"corrupt mp4 structure: {e}") from e

    # -- init / progressive ---------------------------------------------------

    def _parse_moov(self, s: int, e: int):
        d = self.data
        for kind, ts, te in _boxes(d, s, e):
            if kind != b"trak":
                continue
            tkhd = _find(d, ts, te, b"tkhd")
            if tkhd is None:
                raise Mp4Error("trak without tkhd")
            ver, _, ps = _full(d, tkhd[0])
            track_id = struct.unpack_from(
                ">I", d, ps + (16 if ver else 8))[0]
            mdia = _find(d, ts, te, b"mdia")
            if mdia is None:
                continue
            mdhd = _find(d, mdia[0], mdia[1], b"mdhd")
            ver, _, ps = _full(d, mdhd[0])
            timescale = struct.unpack_from(
                ">I", d, ps + (16 if ver else 8))[0]
            hdlr = _find(d, mdia[0], mdia[1], b"hdlr")
            _, _, ps = _full(d, hdlr[0])
            handler = d[ps + 4 : ps + 8].decode("latin1")
            t = TrackInfo(track_id=track_id, handler=handler,
                          codec="", timescale=timescale)
            minf = _find(d, mdia[0], mdia[1], b"minf")
            if minf is not None:
                stbl = _find(d, minf[0], minf[1], b"stbl")
                if stbl is not None:
                    _parse_stbl(d, stbl[0], stbl[1], t)
            # edit list: the common single-entry media_time form shifts the
            # whole track's presentation (leading-media skip); exotic
            # multi-segment edits are out of scope and ignored
            edts = _find(d, ts, te, b"edts")
            if edts is not None:
                elst = _find(d, edts[0], edts[1], b"elst")
                if elst is not None:
                    ver, _, ps = _full(d, elst[0])
                    (n,) = struct.unpack_from(">I", d, ps)
                    ps += 4
                    entry = 20 if ver == 1 else 12
                    for _i in range(min(n, 8)):
                        if ps + entry > elst[1]:
                            raise Mp4Error("elst entries exceed box")
                        if ver == 1:
                            _dur, mt = struct.unpack_from(">Qq", d, ps)
                        else:
                            _dur, mt = struct.unpack_from(">Ii", d, ps)
                        ps += entry
                        if mt >= 0:  # first real edit (-1 = empty edit)
                            t.edit_media_time = mt
                            break
            self.tracks[track_id] = t
        # mvex fragment defaults
        mvex = _find(d, s, e, b"mvex")
        if mvex is not None:
            for kind, bs, be in _boxes(d, mvex[0], mvex[1]):
                if kind != b"trex":
                    continue
                _, _, ps = _full(d, bs)
                tid, _desc, ddur, dsize, dflags = _u32s(d, ps, 5)
                if tid in self.tracks:
                    t = self.tracks[tid]
                    t.default_duration = ddur
                    t.default_size = dsize
                    t.default_flags = dflags

    # -- fragments -------------------------------------------------------------

    def _parse_fragments(self):
        d = self.data
        next_dts: Dict[int, int] = {tid: 0 for tid in self.tracks}
        for kind, s, e, box_start in _boxes4(d, 0, len(d)):
            if kind != b"moof":
                continue
            moof_start = box_start  # largesize-aware anchor
            for tkind, ts, te in _boxes(d, s, e):
                if tkind != b"traf":
                    continue
                self._parse_traf(ts, te, moof_start, next_dts)

    def _parse_traf(self, s: int, e: int, moof_start: int,
                    next_dts: Dict[int, int]):
        d = self.data
        tfhd = _find(d, s, e, b"tfhd")
        if tfhd is None:
            raise Mp4Error("traf without tfhd")
        _, flags, ps = _full(d, tfhd[0])
        (track_id,) = struct.unpack_from(">I", d, ps)
        ps += 4
        t = self.tracks.get(track_id)
        if t is None:
            return
        # default-base-is-moof and the spec default for a first traf both
        # anchor at the moof; chained-traf implicit bases (no flag, traf>1)
        # are not produced by any mux we ingest and would need sample-end
        # tracking here
        base = moof_start
        if flags & _TFHD_BASE_OFFSET:
            (base,) = struct.unpack_from(">Q", d, ps)
            ps += 8
        if flags & _TFHD_DESC_INDEX:
            ps += 4
        def_dur = t.default_duration
        def_size = t.default_size
        def_flags = t.default_flags
        if flags & _TFHD_DEF_DURATION:
            (def_dur,) = struct.unpack_from(">I", d, ps)
            ps += 4
        if flags & _TFHD_DEF_SIZE:
            (def_size,) = struct.unpack_from(">I", d, ps)
            ps += 4
        if flags & _TFHD_DEF_FLAGS:
            (def_flags,) = struct.unpack_from(">I", d, ps)
            ps += 4

        dts = next_dts.get(track_id, 0)
        tfdt = _find(d, s, e, b"tfdt")
        if tfdt is not None:
            ver, _, tp = _full(d, tfdt[0])
            dts = struct.unpack_from(">Q" if ver else ">I", d, tp)[0]

        # without the data-offset flag a trun continues immediately after
        # the previous run's data (ISO 14496-12 8.8.8); track that here
        next_at = base
        for kind, bs, be in _boxes(d, s, e):
            if kind != b"trun":
                continue
            ver, tflags, tp = _full(d, bs)
            count = _check_count(struct.unpack_from(">I", d, tp)[0], "trun")
            tp += 4
            at = next_at
            if tflags & _TRUN_DATA_OFFSET:
                (doff,) = struct.unpack_from(">i", d, tp)
                tp += 4
                at = base + doff
            first_flags = None
            if tflags & _TRUN_FIRST_FLAGS:
                (first_flags,) = struct.unpack_from(">I", d, tp)
                tp += 4
            for i in range(count):
                dur, size, sflags = def_dur, def_size, def_flags
                if tflags & _TRUN_DURATION:
                    (dur,) = struct.unpack_from(">I", d, tp)
                    tp += 4
                if tflags & _TRUN_SIZE:
                    (size,) = struct.unpack_from(">I", d, tp)
                    tp += 4
                if tflags & _TRUN_FLAGS:
                    (sflags,) = struct.unpack_from(">I", d, tp)
                    tp += 4
                elif i == 0 and first_flags is not None:
                    sflags = first_flags
                cts_off = 0
                if tflags & _TRUN_CTS:
                    (cts_off,) = struct.unpack_from(
                        ">i" if ver else ">I", d, tp)
                    tp += 4
                t.samples.append(Sample(
                    offset=at, size=size, dts=dts, cts_offset=cts_off,
                    key=not (sflags & _NON_SYNC_BIT)))
                at += size
                dts += dur
            next_at = at
        next_dts[track_id] = dts

    # -- access ----------------------------------------------------------------

    def sample_data(self, sample: Sample) -> bytes:
        if (sample.offset < 0 or sample.size < 0
                or sample.offset + sample.size > len(self.data)):
            raise Mp4Error("sample outside file")
        return bytes(self.data[sample.offset : sample.offset + sample.size])

    def video_track(self) -> Optional[TrackInfo]:
        for t in self.tracks.values():
            if t.handler == "vide" and t.samples:
                return t
        return None

    def audio_track(self) -> Optional[TrackInfo]:
        for t in self.tracks.values():
            if t.handler == "soun" and t.samples:
                return t
        return None
