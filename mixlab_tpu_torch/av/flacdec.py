"""Pure-Python FLAC decoder — the symmetric half of av/flacenc.py.

The port's copy of ``mixlab_tpu/av/flacdec.py``.

Full bitstream scope (what real-world encoders emit, beyond what our own
encoder produces): CONSTANT / VERBATIM / FIXED 0-4 / LPC 1-32 subframes,
rice methods 0 and 1 with any partition order and escape partitions,
wasted bits, all stereo decorrelation modes, all block-size/sample-rate/
sample-size header encodings, UTF-8 coded numbers, CRC-8 and CRC-16
verification.  8/16/24-bit streams.

Used by media_source for .flac library playback, and validated against
libavcodec's ENCODER output — which exercises the LPC path our encoder
never emits — plus round trips of our own encoder in
tests/test_flacdec.py.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from mixlab_tpu_torch.av.flacenc import crc8, crc16


class FlacError(ValueError):
    pass


_BLOCKSIZE_TABLE = {
    0b0001: 192,
    0b0010: 576, 0b0011: 1152, 0b0100: 2304, 0b0101: 4608,
    0b1000: 256, 0b1001: 512, 0b1010: 1024, 0b1011: 2048,
    0b1100: 4096, 0b1101: 8192, 0b1110: 16384, 0b1111: 32768,
}
_RATE_TABLE = {
    0b0001: 88200, 0b0010: 176400, 0b0011: 192000, 0b0100: 8000,
    0b0101: 16000, 0b0110: 22050, 0b0111: 24000, 0b1000: 32000,
    0b1001: 44100, 0b1010: 48000, 0b1011: 96000,
}
_BPS_TABLE = {0b001: 8, 0b010: 12, 0b100: 16, 0b101: 20, 0b110: 24,
              0b111: 32}


class _BitReader:
    """MSB-first reader with unary support (byte-windowed peeks)."""

    def __init__(self, data: bytes):
        self.data = data
        self.bitpos = 0
        self.nbits = len(data) * 8

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        if self.bitpos + n > self.nbits:
            raise FlacError("bitstream truncated")
        byte = self.bitpos >> 3
        need = ((self.bitpos & 7) + n + 7) >> 3
        word = int.from_bytes(self.data[byte : byte + need], "big")
        shift = need * 8 - (self.bitpos & 7) - n
        self.bitpos += n
        return (word >> shift) & ((1 << n) - 1)

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if n and v >= (1 << (n - 1)) else v

    def read_unary(self) -> int:
        q = 0
        while True:
            if self.bitpos >= self.nbits:
                raise FlacError("unary ran off the stream")
            byte = self.bitpos >> 3
            rem = 8 - (self.bitpos & 7)
            window = self.data[byte] & ((1 << rem) - 1)
            if window == 0:
                q += rem
                self.bitpos += rem
                continue
            lead = rem - window.bit_length()
            q += lead
            self.bitpos += lead + 1
            return q

    def align(self):
        self.bitpos = (self.bitpos + 7) & ~7

    def byte_offset(self) -> int:
        return self.bitpos >> 3


def _read_utf8_number(br: _BitReader) -> int:
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n = 0
    mask = 0x40
    while b0 & mask:
        n += 1
        mask >>= 1
    if n == 0 or n > 6:
        raise FlacError("bad coded number")
    value = b0 & (mask - 1)
    for _ in range(n):
        c = br.read(8)
        if (c & 0xC0) != 0x80:
            raise FlacError("bad coded-number continuation")
        value = (value << 6) | (c & 0x3F)
    return value


def _read_residual(br: _BitReader, blocksize: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise FlacError(f"reserved residual method {method}")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    porder = br.read(4)
    if blocksize % (1 << porder):
        raise FlacError("partition order does not divide block size")
    res = np.empty(blocksize - order, np.int64)
    pos = 0
    for p in range(1 << porder):
        n = (blocksize >> porder) - (order if p == 0 else 0)
        if n < 0:
            raise FlacError("order exceeds first partition")
        k = br.read(plen)
        if k == escape:
            bits = br.read(5)
            for i in range(n):
                res[pos + i] = br.read_signed(bits) if bits else 0
        else:
            for i in range(n):
                q = br.read_unary()
                u = (q << k) | br.read(k)
                res[pos + i] = (u >> 1) ^ -(u & 1)  # un-zigzag
        pos += n
    return res


_FIXED_COEFS = {
    0: (),
    1: (1,),
    2: (2, -1),
    3: (3, -3, 1),
    4: (4, -6, 4, -1),
}


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise FlacError("subframe pad bit set")
    kind = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
        bps -= wasted
    if kind == 0b000000:
        out = np.full(blocksize, br.read_signed(bps), np.int64)
    elif kind == 0b000001:
        out = np.array([br.read_signed(bps) for _ in range(blocksize)],
                       np.int64)
    elif 0b001000 <= kind <= 0b001100:
        order = kind & 0x07
        warm = [br.read_signed(bps) for _ in range(order)]
        res = _read_residual(br, blocksize, order)
        out = np.empty(blocksize, np.int64)
        out[:order] = warm
        coefs = _FIXED_COEFS[order]
        for i in range(order, blocksize):
            acc = res[i - order]
            for j, c in enumerate(coefs):
                acc += c * out[i - 1 - j]
            out[i] = acc
    elif kind & 0b100000:
        order = (kind & 0x1F) + 1
        warm = [br.read_signed(bps) for _ in range(order)]
        precision = br.read(4)
        if precision == 0b1111:
            raise FlacError("invalid LPC precision")
        precision += 1
        shift = br.read_signed(5)
        if shift < 0:
            raise FlacError("negative LPC shift")
        coefs = [br.read_signed(precision) for _ in range(order)]
        res = _read_residual(br, blocksize, order)
        out = np.empty(blocksize, np.int64)
        out[:order] = warm
        co = out.tolist()  # python ints: LPC accumulators can exceed 64 bits
        for i in range(order, blocksize):
            acc = 0
            for j in range(order):
                acc += coefs[j] * co[i - 1 - j]
            co[i] = (acc >> shift) + int(res[i - order])
        out = np.array(co, np.int64)
    else:
        raise FlacError(f"reserved subframe type {kind:06b}")
    return out << wasted


class FlacDecoder:
    """Streaming decoder: construct from STREAMINFO (34 bytes or a whole
    'fLaC' header), then ``decode_frame`` per frame / ``decode_stream``."""

    def __init__(self, streaminfo: bytes):
        if streaminfo[:4] == b"fLaC":
            streaminfo = streaminfo[8:42]  # skip magic + block header
        if len(streaminfo) < 34:
            raise FlacError("short STREAMINFO")
        si = streaminfo
        self.sample_rate = (si[10] << 12) | (si[11] << 4) | (si[12] >> 4)
        self.channels = ((si[12] >> 1) & 0x07) + 1
        self.bps = (((si[12] & 1) << 4) | (si[13] >> 4)) + 1
        if not self.sample_rate:
            raise FlacError("bad sample rate")

    def decode_frame(self, data: bytes, offset: int = 0
                     ) -> Tuple[np.ndarray, int]:
        """Decode ONE frame starting at ``offset``; returns (pcm [n, ch]
        int32, bytes consumed)."""
        br = _BitReader(data)
        br.bitpos = offset * 8
        start = br.byte_offset()
        if br.read(14) != 0b11111111111110:
            raise FlacError("bad sync")
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_bits = br.read(4)
        sr_bits = br.read(4)
        ch_bits = br.read(4)
        bps_bits = br.read(3)
        br.read(1)  # reserved
        _num = _read_utf8_number(br)
        if bs_bits == 0:
            raise FlacError("reserved block size")
        elif bs_bits == 0b0110:
            blocksize = br.read(8) + 1
        elif bs_bits == 0b0111:
            blocksize = br.read(16) + 1
        else:
            blocksize = _BLOCKSIZE_TABLE[bs_bits]
        if sr_bits == 0:
            rate = self.sample_rate
        elif sr_bits == 0b1100:
            rate = br.read(8) * 1000
        elif sr_bits == 0b1101:
            rate = br.read(16)
        elif sr_bits == 0b1110:
            rate = br.read(16) * 10
        elif sr_bits == 0b1111:
            raise FlacError("invalid sample-rate bits")
        else:
            rate = _RATE_TABLE[sr_bits]
        bps = self.bps if bps_bits == 0 else _BPS_TABLE.get(bps_bits)
        if bps is None:
            raise FlacError("reserved sample size")
        header_end = br.byte_offset()
        if crc8(data[start:header_end]) != br.read(8):
            raise FlacError("frame header CRC mismatch")

        if ch_bits <= 0b0111:
            nch = ch_bits + 1
            chans = [_decode_subframe(br, blocksize, bps) for _ in range(nch)]
        elif ch_bits in (0b1000, 0b1001, 0b1010):
            if ch_bits == 0b1000:  # left/side
                a = _decode_subframe(br, blocksize, bps)
                b = _decode_subframe(br, blocksize, bps + 1)
                chans = [a, a - b]
            elif ch_bits == 0b1001:  # right/side (side first)
                a = _decode_subframe(br, blocksize, bps + 1)
                b = _decode_subframe(br, blocksize, bps)
                chans = [b + a, b]
            else:  # mid/side
                mid = _decode_subframe(br, blocksize, bps)
                side = _decode_subframe(br, blocksize, bps + 1)
                total = (mid << 1) | (side & 1)
                chans = [(total + side) >> 1, (total - side) >> 1]
        else:
            raise FlacError(f"reserved channel assignment {ch_bits:04b}")
        del rate  # per-frame rate overrides are legal; STREAMINFO's governs

        br.align()
        body_end = br.byte_offset()
        footer = br.read(16)
        if crc16(data[start:body_end]) != footer:
            raise FlacError("frame CRC-16 mismatch")
        pcm = np.stack(chans, axis=1).astype(np.int32)
        return pcm, br.byte_offset() - start

    def decode_stream(self, data: bytes) -> np.ndarray:
        """Decode back-to-back frames (no container) -> [n, ch] int32."""
        out: List[np.ndarray] = []
        pos = 0
        while pos + 4 <= len(data):
            pcm, used = self.decode_frame(data, pos)
            out.append(pcm)
            pos += used
        if not out:
            return np.zeros((0, self.channels), np.int32)
        return np.concatenate(out)


def decode_flac_file(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Whole .flac file -> (pcm [n, ch] int32, sample_rate, bps).

    Walks the metadata blocks to the first audio frame and trims the tail
    to STREAMINFO's total-samples count when present."""
    if data[:4] != b"fLaC":
        raise FlacError("not a FLAC file")
    pos = 4
    streaminfo = None
    while pos + 4 <= len(data):
        head = data[pos]
        length = int.from_bytes(data[pos + 1 : pos + 4], "big")
        if (head & 0x7F) == 0:
            streaminfo = data[pos + 4 : pos + 4 + length]
        pos += 4 + length
        if head & 0x80:
            break
    if streaminfo is None:
        raise FlacError("missing STREAMINFO")
    dec = FlacDecoder(streaminfo)
    pcm = dec.decode_stream(data[pos:])
    total = ((streaminfo[13] & 0x0F) << 32) | int.from_bytes(
        streaminfo[14:18], "big")
    if total and len(pcm) > total:
        pcm = pcm[:total]
    return pcm, dec.sample_rate, dec.bps
