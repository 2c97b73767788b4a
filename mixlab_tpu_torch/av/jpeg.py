"""Pure-Python JPEG decoder (ITU-T T.81, Huffman DCT).

The port's copy of ``mixlab_tpu/av/jpeg.py``.

Capability layer for media_source stills / MJPEG without codec libraries
(the reference decodes images and MJPEG via ffmpeg, ``src/module/
media_source.rs:185-292``; this is the zero-dependency decoder alongside
av/y4m.py).

Scope: baseline/extended sequential (SOF0/SOF1) AND progressive (SOF2)
8-bit, grayscale or YCbCr with any of the common samplings (4:4:4, 4:2:2,
4:2:0), restart markers, multi-scan files.  Progressive covers all four
scan classes of T.81 Annex G: DC first, DC successive-approximation
refinement, AC first with EOB runs, and AC refinement with correction
bits (the libjpeg decode_mcu_AC_refine discipline).  Arithmetic coding
and 12-bit precision raise typed errors.
Output is yuv420p planes for the engine's Picture type; the inverse DCT is
batched float matrix algebra over every block at once, and the Huffman
entropy decode is the only per-symbol Python.

Accuracy: validated in tests against libavcodec's decode of the same
bytes (mean error well under 1 LSB; IDCT rounding differs by at most 1);
progressive decode is additionally cross-checked against Pillow's libjpeg.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


class JpegError(ValueError):
    pass


# 8x8 zigzag scan order (flat row-major indices)
ZIGZAG8 = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)

# IDCT basis: A[u, x] = c(u)/2 * cos((2x+1) u pi / 16)
_A = np.zeros((8, 8), np.float64)
for _u in range(8):
    _c = (1 / np.sqrt(2)) if _u == 0 else 1.0
    for _x in range(8):
        _A[_u, _x] = _c / 2.0 * np.cos((2 * _x + 1) * _u * np.pi / 16)


@dataclass
class _Component:
    cid: int
    h: int
    v: int
    tq: int
    dc_tab: int = 0
    ac_tab: int = 0


class _HuffLUT:
    """Canonical Huffman table -> flat 16-bit peek LUT (symbol, length)."""

    def __init__(self, bits: bytes, vals: bytes):
        self.sym = np.zeros(1 << 16, np.int16)
        self.len = np.zeros(1 << 16, np.int8)
        code = 0
        k = 0
        for length in range(1, 17):
            for _ in range(bits[length - 1]):
                sym = vals[k]
                k += 1
                lo = code << (16 - length)
                hi = lo + (1 << (16 - length))
                self.sym[lo:hi] = sym
                self.len[lo:hi] = length
                code += 1
            code <<= 1


class _BitReader:
    """MSB-first reader over destuffed entropy bytes."""

    def __init__(self, data: bytes):
        self.data = data + b"\x00" * 4  # padding for peeks past the end
        self.bitpos = 0
        self.limit = len(data) * 8

    def peek16(self) -> int:
        byte = self.bitpos >> 3
        word = int.from_bytes(self.data[byte : byte + 4], "big")
        return (word >> (16 - (self.bitpos & 7))) & 0xFFFF

    def skip(self, n: int):
        self.bitpos += n

    def receive(self, n: int) -> int:
        if n == 0:
            return 0
        v = self.peek16() >> (16 - n)
        self.bitpos += n
        return v

    def exhausted(self) -> bool:
        return self.bitpos >= self.limit


def _extend(v: int, t: int) -> int:
    # T.81 F.12: map magnitude bits to signed value
    if t == 0:
        return 0
    return v if v >= (1 << (t - 1)) else v - (1 << t) + 1


def _destuff(data: bytes) -> bytes:
    return data.replace(b"\xff\x00", b"\xff")


def decode_jpeg(data: bytes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """JPEG bytes -> (y, u, v) uint8 planes at 4:2:0 (grayscale: flat
    chroma).  Baseline/extended sequential AND progressive (SOF2).
    Raises JpegError for arithmetic/12-bit/lossless files and for ANY
    malformed input (uploads are untrusted; structural index/struct
    errors are normalized to JpegError so callers need one except)."""
    try:
        return _decode_jpeg(data)
    except JpegError:
        raise
    except (IndexError, ValueError, KeyError, struct.error,
            ZeroDivisionError) as e:
        raise JpegError(f"malformed JPEG: {type(e).__name__}: {e}") from None


_MAX_PIXELS = 8192 * 8192


def _entropy_end(data: bytes, start: int) -> int:
    """Index of the next real marker (not stuffing, not RSTn) after
    ``start`` — the end of one scan's entropy-coded data."""
    q = start
    while True:
        q = data.find(b"\xff", q)
        if q < 0 or q + 1 >= len(data):
            return len(data)
        m = data[q + 1]
        if m == 0x00 or 0xD0 <= m <= 0xD7:
            q += 2
            continue
        if m == 0xFF:  # fill byte
            q += 1
            continue
        return q


def _split_restarts(scan: bytes) -> List[bytes]:
    """Split entropy data on RSTn markers (destuffed)."""
    intervals: List[bytes] = []
    p = 0
    while True:
        q = p
        cut = None
        while True:
            q = scan.find(b"\xff", q)
            if q < 0 or q + 1 >= len(scan):
                break
            m = scan[q + 1]
            if 0xD0 <= m <= 0xD7:
                cut = q
                break
            q += 2 if m == 0x00 else 1
        if cut is None:
            intervals.append(_destuff(scan[p:]))
            return intervals
        intervals.append(_destuff(scan[p:cut]))
        p = cut + 2


class _ScanDecoder:
    """One SOS scan over the per-component coefficient grids.

    Implements the T.81 scan classes: sequential (DC+AC in one pass) and
    the four progressive Annex-G classes — DC first, DC refine, AC first
    with EOB runs, AC refine with correction bits (the libjpeg
    decode_mcu_AC_refine discipline)."""

    def __init__(self, huff, ss, se, ah, al, n_comps, sequential):
        self.huff = huff
        self.ss, self.se, self.ah, self.al = ss, se, ah, al
        self.sequential = sequential
        self.preds = [0] * n_comps
        self.eobrun = 0

    def _lut(self, tc, th):
        try:
            return self.huff[(tc, th)]
        except KeyError as e:
            raise JpegError(f"scan references undefined "
                            f"Huffman table {e}") from None

    def reset(self):  # at restart markers
        self.preds = [0] * len(self.preds)
        self.eobrun = 0

    def _dc(self, br, block, si, c):
        lut = self._lut(0, c.dc_tab)
        pk = br.peek16()
        t = int(lut.sym[pk])
        ln = int(lut.len[pk])
        if ln == 0:
            raise JpegError("bad DC code")
        br.skip(ln)
        self.preds[si] += _extend(br.receive(t), t)
        block[0] = self.preds[si] << self.al

    def _dc_refine(self, br, block):
        if br.receive(1):
            block[0] |= 1 << self.al

    def _ac_sequential(self, br, block, c):
        lut = self._lut(1, c.ac_tab)
        k = 1
        while k < 64:
            pk = br.peek16()
            rs = int(lut.sym[pk])
            ln = int(lut.len[pk])
            if ln == 0:
                raise JpegError("bad AC code")
            br.skip(ln)
            if rs == 0:
                break  # EOB
            r, s = rs >> 4, rs & 15
            if s == 0:
                if r != 15:
                    raise JpegError("bad AC run")
                k += 16  # ZRL
                continue
            k += r
            if k > 63:
                raise JpegError("AC overflow")
            block[k] = _extend(br.receive(s), s)
            k += 1

    def _ac_first(self, br, block, c):
        if self.eobrun > 0:
            self.eobrun -= 1
            return
        lut = self._lut(1, c.ac_tab)
        k = self.ss
        while k <= self.se:
            pk = br.peek16()
            rs = int(lut.sym[pk])
            ln = int(lut.len[pk])
            if ln == 0:
                raise JpegError("bad AC code")
            br.skip(ln)
            r, s = rs >> 4, rs & 15
            if s == 0:
                if r < 15:
                    self.eobrun = (1 << r) - 1 + br.receive(r)
                    return
                k += 16  # ZRL
                continue
            k += r
            if k > self.se:
                raise JpegError("AC overflow")
            block[k] = _extend(br.receive(s), s) << self.al
            k += 1

    def _ac_refine(self, br, block, c):
        # T.81 G.1.2.3 / libjpeg decode_mcu_AC_refine: correction bits for
        # already-nonzero coefficients, newly significant ones at +-1<<Al
        p1 = 1 << self.al
        m1 = -p1
        k = self.ss

        def correct(idx):
            coef = int(block[idx])
            if br.receive(1) and (coef & p1) == 0:
                block[idx] = coef + (p1 if coef >= 0 else m1)

        if self.eobrun == 0:
            lut = self._lut(1, c.ac_tab)
            while k <= self.se:
                pk = br.peek16()
                rs = int(lut.sym[pk])
                ln = int(lut.len[pk])
                if ln == 0:
                    raise JpegError("bad AC code")
                br.skip(ln)
                r, s = rs >> 4, rs & 15
                val = 0
                if s == 0:
                    if r < 15:
                        self.eobrun = (1 << r) + br.receive(r)
                        break  # finish this block in the EOB epilogue
                    # r == 15: ZRL — advance over 16 zero-history coeffs
                else:
                    if s != 1:
                        raise JpegError("bad AC refine size")
                    val = p1 if br.receive(1) else m1
                # advance over r zero-history coefficients, appending
                # correction bits to nonzero ones along the way
                while k <= self.se:
                    if block[k] != 0:
                        correct(k)
                    else:
                        if r == 0:
                            break
                        r -= 1
                    k += 1
                if val:
                    if k > self.se:
                        raise JpegError("AC refine overflow")
                    block[k] = val
                k += 1
        if self.eobrun > 0:
            while k <= self.se:
                if block[k] != 0:
                    correct(k)
                k += 1
            self.eobrun -= 1

    def decode_block(self, br, block, si, c):
        if self.sequential:
            self._dc(br, block, si, c)
            self._ac_sequential(br, block, c)
        elif self.ss == 0:
            if self.ah == 0:
                self._dc(br, block, si, c)
            else:
                self._dc_refine(br, block)
        else:
            if self.ah == 0:
                self._ac_first(br, block, c)
            else:
                self._ac_refine(br, block, c)


def _decode_jpeg(data: bytes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    if data[:2] != b"\xff\xd8":
        raise JpegError("missing SOI")
    pos = 2
    qt: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], _HuffLUT] = {}
    comps: List[_Component] = []
    width = height = 0
    restart_interval = 0
    progressive = False
    scans: List[tuple] = []

    while pos < len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        pos += 2
        if marker in (0x01,) or 0xD0 <= marker <= 0xD9:
            if marker == 0xD9:
                break
            continue
        (seglen,) = struct.unpack_from(">H", data, pos)
        seg = data[pos + 2 : pos + seglen]
        if marker == 0xDB:  # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                p += 1
                if pq:
                    table = np.frombuffer(seg, ">u2", 64, p).astype(np.int64)
                    p += 128
                else:
                    table = np.frombuffer(seg, np.uint8, 64, p).astype(np.int64)
                    p += 64
                qt[tq] = table  # zigzag order
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0/SOF1 sequential, SOF2 prog
            progressive = marker == 0xC2
            precision = seg[0]
            if precision != 8:
                raise JpegError(f"{precision}-bit JPEG unsupported")
            height, width = struct.unpack_from(">HH", seg, 1)
            if not height or not width or height * width > _MAX_PIXELS:
                raise JpegError(f"bad dimensions {width}x{height}")
            ncomp = seg[5]
            if ncomp not in (1, 3):
                raise JpegError(f"unsupported component count {ncomp}")
            comps = []
            for i in range(ncomp):
                cid, hv, tq = seg[6 + 3 * i : 9 + 3 * i]
                comps.append(_Component(cid, hv >> 4, hv & 15, tq))
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                        0xCD, 0xCE, 0xCF):
            raise JpegError(f"unsupported SOF marker 0xFF{marker:02X} "
                            "(lossless/arithmetic/hierarchical)")
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                bits = seg[p + 1 : p + 17]
                n = sum(bits)
                vals = seg[p + 17 : p + 17 + n]
                huff[(tc, th)] = _HuffLUT(bits, vals)
                p += 17 + n
        elif marker == 0xDD:  # DRI
            (restart_interval,) = struct.unpack_from(">H", seg, 0)
        elif marker == 0xDA:  # SOS
            if not comps:
                raise JpegError("SOS before SOF")
            ns = seg[0]
            by_id = {c.cid: c for c in comps}
            scan_cis: List[int] = []
            tabs_now: List[Tuple[int, int]] = []
            for i in range(ns):
                cid, tabs = seg[1 + 2 * i : 3 + 2 * i]
                if cid not in by_id:
                    raise JpegError(f"scan references unknown component {cid}")
                scan_cis.append(comps.index(by_id[cid]))
                tabs_now.append((tabs >> 4, tabs & 15))
            ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
            ahal = seg[3 + 2 * ns]
            scan_start = pos + seglen
            scan_end = _entropy_end(data, scan_start)
            # snapshot the table dict: progressive files redefine DHT
            # slots between scans, and each scan must use the tables in
            # effect at ITS header, not the file's final definitions
            scans.append((scan_cis, tabs_now, ss, se, ahal >> 4, ahal & 15,
                          _split_restarts(data[scan_start:scan_end]),
                          restart_interval, dict(huff)))
            pos = scan_end
            continue
        pos += seglen

    if not scans or not comps:
        raise JpegError("no scan found")

    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcu_cols = -(-width // (8 * hmax))
    mcu_rows = -(-height // (8 * vmax))
    n_mcu = mcu_cols * mcu_rows

    # per-component coefficient grids [rows*cols, 64] (zigzag order),
    # MCU-padded: rows = mcu_rows*v, cols = mcu_cols*h
    grid_cols = [mcu_cols * c.h for c in comps]
    coeffs = [np.zeros((mcu_rows * c.v * mcu_cols * c.h, 64), np.int32)
              for c in comps]

    # ---- Huffman decode, scan by scan (the only per-symbol Python) ----
    for (scan_cis, tabs_now, ss, se, ah, al, intervals, ri,
         huff_now) in scans:
        scomps = []
        for ci, (dct, act) in zip(scan_cis, tabs_now):
            c = comps[ci]
            c.dc_tab, c.ac_tab = dct, act
            scomps.append((ci, c))
        if progressive:
            if ss == 0 and se != 0:
                raise JpegError("bad progressive spectral selection")
            if ss > 0 and len(scomps) != 1:
                raise JpegError("interleaved progressive AC scan")
        else:
            ss, se, ah, al = 0, 63, 0, 0
        dec = _ScanDecoder(huff_now, ss, se, ah, al, len(scomps),
                           sequential=not progressive)
        interleaved = len(scomps) > 1
        if interleaved:
            units = n_mcu
            bw = 0
        else:
            ci0, c0 = scomps[0]
            bw = -(-(-(-width * c0.h // hmax)) // 8)
            bh = -(-(-(-height * c0.v // vmax)) // 8)
            units = bw * bh
        unit = 0
        for interval in intervals:
            br = _BitReader(interval)
            dec.reset()
            limit = min(unit + ri, units) if ri else units
            while unit < limit:
                if interleaved:
                    my, mx = divmod(unit, mcu_cols)
                    for si, (ci, c) in enumerate(scomps):
                        gc = grid_cols[ci]
                        for bv in range(c.v):
                            for bh2 in range(c.h):
                                row = my * c.v + bv
                                col = mx * c.h + bh2
                                dec.decode_block(
                                    br, coeffs[ci][row * gc + col], si, c)
                else:
                    ci, c = scomps[0]
                    row, col = divmod(unit, bw)
                    dec.decode_block(
                        br, coeffs[ci][row * grid_cols[ci] + col], 0, c)
                unit += 1
                # truncation = consuming bits past the data (plus the
                # zero padding a final partial byte legitimately peeks);
                # merely reaching the end is NOT truncation — progressive
                # EOB runs cover trailing blocks with zero bits consumed
                if br.bitpos > br.limit + 16 and unit < limit:
                    raise JpegError("entropy data truncated")
            if unit >= units:
                break

    # ---- batched dequant + IDCT per component ----
    planes = []
    for ci, c in enumerate(comps):
        if c.tq not in qt:
            raise JpegError(f"undefined quant table {c.tq}")
        zz = coeffs[ci].astype(np.float64) * qt[c.tq][None, :]
        blocks = np.zeros((len(zz), 64), np.float64)
        blocks[:, ZIGZAG8] = zz
        blocks = blocks.reshape(-1, 8, 8)
        spatial = np.einsum("ux,buv,vy->bxy", _A, blocks, _A)
        px = np.clip(np.round(spatial + 128.0), 0, 255).astype(np.uint8)
        # assemble from the padded block grid
        gr, gc = mcu_rows * c.v, grid_cols[ci]
        plane = px.reshape(gr, gc, 8, 8).transpose(0, 2, 1, 3).reshape(
            gr * 8, gc * 8)
        cw = -(-width * c.h // hmax)
        ch = -(-height * c.v // vmax)
        planes.append(plane[:ch, :cw])

    # ---- to yuv420p ----
    y = planes[0][:height, :width]
    if height % 2 or width % 2:
        # pad to even (engine Pictures are 4:2:0-aligned)
        y = np.pad(y, ((0, height % 2), (0, width % 2)), mode="edge")
        height += height % 2
        width += width % 2
    if len(planes) == 1:
        flat = np.full((height // 2, width // 2), 128, np.uint8)
        return y, flat, flat.copy()

    def _avg_pairs(p: np.ndarray, axis: int) -> np.ndarray:
        a = p[0::2] if axis == 0 else p[:, 0::2]
        b = p[1::2] if axis == 0 else p[:, 1::2]
        if b.shape[axis] < a.shape[axis]:  # odd count: replicate the edge
            pad = [(0, 0), (0, 0)]
            pad[axis] = (0, 1)
            b = np.pad(b, pad, mode="edge") if b.size else a
        return ((a.astype(np.uint16) + b + 1) // 2).astype(np.uint8)

    out_c = []
    tgt_h, tgt_w = height // 2, width // 2
    for plane, c in zip(planes[1:3], comps[1:3]):
        p = plane
        if p.shape[0] >= height:  # vertically full-res (4:2:2 / 4:4:4)
            p = _avg_pairs(p, 0)
        if p.shape[1] >= width:  # horizontally full-res (4:4:4)
            p = _avg_pairs(p, 1)
        p = p[:tgt_h, :tgt_w]
        if p.shape != (tgt_h, tgt_w):
            p = np.pad(p, ((0, tgt_h - p.shape[0]), (0, tgt_w - p.shape[1])),
                       mode="edge")
        out_c.append(np.ascontiguousarray(p))
    return np.ascontiguousarray(y), out_c[0], out_c[1]


def is_jpeg(data: bytes) -> bool:
    return data[:2] == b"\xff\xd8"
