"""YUV4MPEG2 (.y4m) reader/writer — the zero-dependency raw-video format.

The port's copy of ``mixlab_tpu/av/y4m.py``.

Capability layer for media_source video playback without codec libraries
(the reference plays video files via ffmpeg, ``src/module/media_source.rs:
185-292``; Y4M is the pure tier: header + uncompressed yuv planes, which
go straight to device memory).

Supported: C420 family (420, 420jpeg, 420mpeg2, 420paldv — all stored
identically), C422 and C444 (chroma box-averaged down to 420 to match the
engine's yuv420p Picture), any frame rate / aspect, FRAME parameter tails.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Iterator, Optional, Tuple

import numpy as np

MAGIC = b"YUV4MPEG2"


class Y4mError(ValueError):
    pass


@dataclass(frozen=True)
class Y4mInfo:
    width: int
    height: int
    fps: Fraction
    colorspace: str  # "420" | "422" | "444"
    header_len: int  # bytes up to and including the header newline

    @property
    def frame_size(self) -> int:
        y = self.width * self.height
        if self.colorspace == "420":
            return y + y // 2
        if self.colorspace == "422":
            return y * 2
        return y * 3


def parse_header(data: bytes) -> Y4mInfo:
    end = data.find(b"\n")
    if end < 0 or not data.startswith(MAGIC):
        raise Y4mError("not a YUV4MPEG2 stream")
    width = height = None
    fps = Fraction(25, 1)
    cs = "420"
    for tok in data[len(MAGIC):end].split(b" "):
        if not tok:
            continue
        tag, val = tok[:1], tok[1:].decode("ascii", "replace")
        if tag == b"W":
            width = int(val)
        elif tag == b"H":
            height = int(val)
        elif tag == b"F":
            n, _, d = val.partition(":")
            if int(d or 1) <= 0 or int(n) <= 0:
                raise Y4mError(f"bad frame rate F{val}")
            fps = Fraction(int(n), int(d or 1))
        elif tag == b"C":
            # exact 8-bit variants only — C420p10/C444alpha etc. have a
            # different frame layout and must NOT silently alias
            if val in ("420", "420jpeg", "420mpeg2", "420paldv"):
                cs = "420"
            elif val == "422":
                cs = "422"
            elif val == "444":
                cs = "444"
            else:
                raise Y4mError(f"unsupported colorspace C{val}")
        # I (interlace), A (aspect), X (extensions): accepted and ignored
    if not width or not height:
        raise Y4mError("missing W/H in Y4M header")
    if width % 2 or height % 2:
        raise Y4mError("odd dimensions unsupported (yuv420 target)")
    return Y4mInfo(width, height, fps, cs, end + 1)


def _to_420(u: np.ndarray, v: np.ndarray, cs: str):
    if cs == "420":
        return u, v
    if cs == "422":  # [H, W/2] -> average vertical pairs
        return (
            ((u[0::2].astype(np.uint16) + u[1::2] + 1) // 2).astype(np.uint8),
            ((v[0::2].astype(np.uint16) + v[1::2] + 1) // 2).astype(np.uint8),
        )
    # 444: 2x2 box average
    def box(p):
        p16 = p.astype(np.uint16)
        return ((p16[0::2, 0::2] + p16[0::2, 1::2]
                 + p16[1::2, 0::2] + p16[1::2, 1::2] + 2) // 4).astype(np.uint8)
    return box(u), box(v)


class Y4mReader:
    """Frame iterator over a seekable stream (project ReadStream/file)."""

    def __init__(self, stream):
        self.stream = stream
        stream.seek(0)
        head = stream.read(4096)
        self.info = parse_header(head)
        stream.seek(self.info.header_len)

    def rewind(self):
        self.stream.seek(self.info.header_len)

    def read_frame(self) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """-> (y, u, v) uint8 planes at 4:2:0, or None at EOF."""
        line = bytearray()
        while True:
            b = self.stream.read(1)
            if not b:
                return None
            if b == b"\n":
                break
            line += b
            if len(line) > 256:
                raise Y4mError("FRAME header too long")
        if not bytes(line).startswith(b"FRAME"):
            raise Y4mError(f"bad frame marker: {bytes(line)[:16]!r}")
        info = self.info
        raw = self.stream.read(info.frame_size)
        if len(raw) < info.frame_size:
            return None  # truncated tail
        w, h = info.width, info.height
        y = np.frombuffer(raw, np.uint8, w * h).reshape(h, w)
        if info.colorspace == "420":
            cw, ch = w // 2, h // 2
        elif info.colorspace == "422":
            cw, ch = w // 2, h
        else:
            cw, ch = w, h
        off = w * h
        u = np.frombuffer(raw, np.uint8, cw * ch, off).reshape(ch, cw)
        v = np.frombuffer(raw, np.uint8, cw * ch, off + cw * ch).reshape(ch, cw)
        u, v = _to_420(u, v, info.colorspace)
        return y.copy(), u, v


def write_y4m(frames, fps: Fraction = Fraction(30, 1)) -> bytes:
    """Mux (y, u, v) 4:2:0 planes into a .y4m byte string (tests/tools)."""
    frames = list(frames)
    if not frames:
        raise Y4mError("no frames")
    h, w = frames[0][0].shape
    out = bytearray(
        b"YUV4MPEG2 W%d H%d F%d:%d Ip A1:1 C420jpeg\n"
        % (w, h, fps.numerator, fps.denominator)
    )
    for y, u, v in frames:
        out += b"FRAME\n"
        out += np.asarray(y, np.uint8).tobytes()
        out += np.asarray(u, np.uint8).tobytes()
        out += np.asarray(v, np.uint8).tobytes()
    return bytes(out)
