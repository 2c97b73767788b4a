"""Pure-Python FLAC encoder (the port's copy of ``mixlab_tpu/av/flacenc.py``),
used by ``render_cli`` for ``.flac`` output and, as ``PureFlacStream``, by the
Monitor's pure tier for lossless fMP4 audio (``MIXLAB_PURE_AUDIO=flac``).

Encoder scope (always-compliant subset of the FLAC format):
  * 16-bit PCM, mono/stereo, any sample rate expressible in STREAMINFO
  * per-frame choice of stereo decorrelation: independent, left/side,
    right/side, mid/side (costed exactly, like libFLAC's -m)
  * per-subframe choice: CONSTANT, VERBATIM, or FIXED predictor order 0–4
    (costed exactly over rice parameters)
  * rice residual coding, method 0 (4-bit params) or method 1 (5-bit), one
    partition (partition_order 0)
  * CRC-8 frame-header / CRC-16 whole-frame integrity as required

The residual search and the rice bit-packing are vectorized with numpy (the
per-sample work is ~10 ops, all array-at-a-time); only the few header fields
go through the scalar bit writer.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# CRCs (FLAC frame integrity): CRC-8 poly 0x07, CRC-16 poly 0x8005, init 0
# ---------------------------------------------------------------------------


def _crc_table(poly: int, width: int) -> np.ndarray:
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    table = np.zeros(256, dtype=np.uint32)
    for byte in range(256):
        crc = byte << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if crc & top else (crc << 1)
        table[byte] = crc & mask
    return table


_CRC8_TABLE = _crc_table(0x07, 8)
_CRC16_TABLE = _crc_table(0x8005, 16)


def crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = int(_CRC8_TABLE[crc ^ b])
    return crc


def crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = int(_CRC16_TABLE[((crc >> 8) ^ b) & 0xFF]) ^ ((crc << 8) & 0xFFFF)
    return crc


# ---------------------------------------------------------------------------
# bit writer with vectorized bit-array appends
# ---------------------------------------------------------------------------


class FlacBitWriter:
    """MSB-first writer; bulk appends take a u8 0/1 bit array (numpy)."""

    def __init__(self):
        self._chunks: List[np.ndarray] = []  # aligned byte chunks
        self._bits = np.zeros(0, dtype=np.uint8)  # unaligned tail bits

    def u(self, value: int, n: int):
        if n == 0:
            return
        bits = (value >> np.arange(n - 1, -1, -1, dtype=np.uint32)) & 1
        self.bits(bits.astype(np.uint8))

    def bits(self, arr: np.ndarray):
        self._bits = np.concatenate([self._bits, arr])
        n_whole = len(self._bits) // 8 * 8
        if n_whole:
            self._chunks.append(np.packbits(self._bits[:n_whole]))
            self._bits = self._bits[n_whole:]

    def align_zero(self):
        pad = (-len(self._bits)) % 8
        if pad:
            self.bits(np.zeros(pad, dtype=np.uint8))

    def getvalue(self) -> bytes:
        assert len(self._bits) == 0, "unaligned"
        return b"".join(c.tobytes() for c in self._chunks)


def _utf8_coded_number(value: int) -> bytes:
    """FLAC's UTF-8-style frame/sample number coding (up to 36 bits)."""
    if value < 0x80:
        return bytes([value])
    out = []
    n = 1  # continuation bytes; capacity = (6 - n) + 6 n = 6 + 5 n bits
    while value >= (1 << (6 + 5 * n)) and n < 6:
        n += 1
    # n continuation bytes; lead byte has n+1 ones then a zero
    for _ in range(n):
        out.append(0x80 | (value & 0x3F))
        value >>= 6
    lead_prefix = (0xFF << (7 - n)) & 0xFF
    out.append(lead_prefix | value)
    return bytes(reversed(out))


# ---------------------------------------------------------------------------
# rice coding (vectorized)
# ---------------------------------------------------------------------------


def _zigzag(res: np.ndarray) -> np.ndarray:
    r = res.astype(np.int64)
    return np.where(r >= 0, r << 1, (-r << 1) - 1).astype(np.uint64)


def _best_rice_param(u: np.ndarray, max_k: int = 30) -> Tuple[int, int]:
    """(k, total_bits) minimizing n*(k+1) + sum(u >> k)."""
    n = len(u)
    if n == 0:
        return 0, 0
    best_k, best_bits = 0, None
    hi = int(u.max()).bit_length() if n else 0
    for k in range(0, min(max_k, hi + 1) + 1):
        bits = n * (k + 1) + int((u >> np.uint64(k)).sum())
        if best_bits is None or bits < best_bits:
            best_k, best_bits = k, bits
    return best_k, int(best_bits)


def _write_rice(w: FlacBitWriter, u: np.ndarray, k: int):
    """Append rice codes (q zeros, a one, k low bits) for all samples."""
    q = (u >> np.uint64(k)).astype(np.int64)
    lengths = q + 1 + k
    total = int(lengths.sum())
    bits = np.zeros(total, dtype=np.uint8)
    ends = np.cumsum(lengths)
    starts = ends - lengths
    bits[starts + q] = 1  # unary terminator
    if k:
        shifts = np.arange(k - 1, -1, -1, dtype=np.uint64)
        low = ((u[:, None] >> shifts[None, :]) & np.uint64(1)).astype(np.uint8)
        idx = (starts + q + 1)[:, None] + np.arange(k, dtype=np.int64)[None, :]
        bits[idx.ravel()] = low.ravel()
    w.bits(bits)


# ---------------------------------------------------------------------------
# subframe search + encode
# ---------------------------------------------------------------------------

_FIXED_MAX_ORDER = 4


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    r = x.astype(np.int64)
    for _ in range(order):
        r = np.diff(r)
    return r


class _SubframePlan:
    __slots__ = ("kind", "order", "k", "bits", "residual", "x")

    def __init__(self, kind, order, k, bits, residual, x):
        self.kind = kind        # "constant" | "verbatim" | "fixed"
        self.order = order
        self.k = k              # rice parameter (fixed only)
        self.bits = bits        # total subframe bits incl. 8-bit header
        self.residual = residual
        self.x = x


def _plan_subframe(x: np.ndarray, bps: int) -> _SubframePlan:
    n = len(x)
    if n and int(x.min()) == int(x.max()):
        return _SubframePlan("constant", 0, 0, 8 + bps, None, x)
    best: Optional[_SubframePlan] = None
    for order in range(0, min(_FIXED_MAX_ORDER, n - 1) + 1):
        res = _fixed_residual(x, order)
        u = _zigzag(res)
        k, rice_bits = _best_rice_param(u)
        # header(8) + warmup + residual-method(2) + part-order(4) + param(4|5)
        param_bits = 5 if k > 14 else 4
        bits = 8 + order * bps + 2 + 4 + param_bits + rice_bits
        if best is None or bits < best.bits:
            best = _SubframePlan("fixed", order, k, bits, u, x)
    verbatim_bits = 8 + n * bps
    if best is None or verbatim_bits < best.bits:
        best = _SubframePlan("verbatim", 0, 0, verbatim_bits, None, x)
    return best


def _write_signed(w: FlacBitWriter, values: np.ndarray, bps: int):
    if len(values) == 0:
        return
    vals = values.astype(np.int64) & ((1 << bps) - 1)
    shifts = np.arange(bps - 1, -1, -1, dtype=np.int64)
    bits = ((vals[:, None] >> shifts[None, :]) & 1).astype(np.uint8)
    w.bits(bits.ravel())


def _write_subframe(w: FlacBitWriter, plan: _SubframePlan, bps: int):
    w.u(0, 1)  # zero pad bit
    if plan.kind == "constant":
        w.u(0b000000, 6)
        w.u(0, 1)  # no wasted bits
        _write_signed(w, plan.x[:1], bps)
        return
    if plan.kind == "verbatim":
        w.u(0b000001, 6)
        w.u(0, 1)
        _write_signed(w, plan.x, bps)
        return
    w.u(0b001000 | plan.order, 6)
    w.u(0, 1)
    _write_signed(w, plan.x[: plan.order], bps)  # warmup
    method = 1 if plan.k > 14 else 0
    w.u(method, 2)
    w.u(0, 4)  # partition order 0
    w.u(plan.k, 5 if method else 4)
    _write_rice(w, plan.residual, plan.k)


# ---------------------------------------------------------------------------
# frames + stream
# ---------------------------------------------------------------------------

_CH_INDEPENDENT = None  # marker
_BPS_CODE_16 = 0b100


class FlacEncoder:
    """Frame-at-a-time FLAC encoder for 16-bit PCM.

    ``encode_frame(pcm)`` takes (n, channels) int16 and returns one complete
    FLAC frame (header + subframes + CRC-16) — the unit that FLAC-in-ISO-BMFF
    stores one-per-sample and that libavcodec decodes packet-at-a-time.
    """

    def __init__(self, sample_rate: int = 44100, channels: int = 2,
                 block_size: int = 1024):
        if channels not in (1, 2):
            raise ValueError("flacenc supports mono/stereo")
        self.sample_rate = sample_rate
        self.channels = channels
        self.block_size = block_size
        self.bps = 16
        self.frame_number = 0

    # -- STREAMINFO --------------------------------------------------------

    def streaminfo(self) -> bytes:
        """34-byte STREAMINFO body (libavcodec 'flac' extradata format)."""
        w = FlacBitWriter()
        w.u(self.block_size, 16)  # min block size
        w.u(self.block_size, 16)  # max block size
        w.u(0, 24)  # min frame size unknown
        w.u(0, 24)  # max frame size unknown
        w.u(self.sample_rate, 20)
        w.u(self.channels - 1, 3)
        w.u(self.bps - 1, 5)
        w.u(0, 36)  # total samples unknown
        out = w.getvalue() + b"\x00" * 16  # MD5 unknown
        assert len(out) == 34
        return out

    def streaminfo_block(self) -> bytes:
        """STREAMINFO with metadata-block header (last=1, type=0) — the
        payload of the ISO-BMFF ``dfLa`` box."""
        body = self.streaminfo()
        return bytes([0x80]) + struct.pack(">I", len(body))[1:] + body

    def stream_header(self) -> bytes:
        """'fLaC' magic + STREAMINFO — prefix for a standalone .flac file."""
        return b"fLaC" + self.streaminfo_block()

    # -- frames ------------------------------------------------------------

    def encode_frame(self, pcm: np.ndarray) -> bytes:
        pcm = np.asarray(pcm, dtype=np.int16)
        if pcm.ndim == 1:
            pcm = pcm.reshape(-1, self.channels)
        n, ch = pcm.shape
        assert ch == self.channels

        if ch == 1:
            assignment = 0
            plans = [_plan_subframe(pcm[:, 0], 16)]
            bps_list = [16]
        else:
            left = pcm[:, 0].astype(np.int64)
            right = pcm[:, 1].astype(np.int64)
            mid = (left + right) >> 1
            side = left - right
            p_l = _plan_subframe(left, 16)
            p_r = _plan_subframe(right, 16)
            p_m = _plan_subframe(mid, 16)
            p_s = _plan_subframe(side, 17)
            options = [
                (0b0001, [p_l, p_r], [16, 16]),          # independent LR
                (0b1000, [p_l, p_s], [16, 17]),          # left/side
                (0b1001, [p_s, p_r], [17, 16]),          # right/side (side first)
                (0b1010, [p_m, p_s], [16, 17]),          # mid/side
            ]
            assignment, plans, bps_list = min(
                options, key=lambda o: sum(p.bits for p in o[1])
            )

        # ---- header ----
        w = FlacBitWriter()
        w.u(0b11111111111110, 14)  # sync
        w.u(0, 1)  # reserved
        w.u(0, 1)  # blocking strategy: fixed (frame numbers)
        w.u(0b0111, 4)  # block size: 16-bit value at end of header
        w.u(0b0000, 4)  # sample rate: from STREAMINFO
        w.u(assignment, 4)
        w.u(_BPS_CODE_16, 3)
        w.u(0, 1)  # reserved
        # 32 header bits so far -> byte-aligned for the coded frame number
        num = _utf8_coded_number(self.frame_number)
        for b in num:
            w.u(b, 8)
        w.u(n - 1, 16)
        head_bytes = w.getvalue()
        w.u(crc8(head_bytes), 8)

        for plan, bps in zip(plans, bps_list):
            _write_subframe(w, plan, bps)
        w.align_zero()
        body = w.getvalue()
        frame = body + struct.pack(">H", crc16(body))
        self.frame_number += 1
        return frame


class PureFlacStream:
    """Codec-backend stream interface (the duck type of the AAC streams):
    ``feed(pcm_i16)`` buffers interleaved samples; ``poll_frames()`` yields
    whole FLAC frames of exactly ``block_size`` samples per channel, one
    fMP4 sample each, like the AAC granule (``encode_stream.py``), and
    keeps the remainder."""

    codec = "flac"

    def __init__(self, sample_rate: int = 44100, channels: int = 2,
                 block_size: int = 1024):
        self.sample_rate = sample_rate
        self.channels = channels
        self.block_size = block_size
        self._enc = FlacEncoder(sample_rate, channels, block_size)
        self._buf = np.zeros((0, channels), dtype=np.int16)

    def feed(self, pcm_i16: np.ndarray):
        pcm = np.asarray(pcm_i16, dtype=np.int16).reshape(-1, self.channels)
        self._buf = np.concatenate([self._buf, pcm]) if len(self._buf) else pcm

    def poll_frames(self) -> List[bytes]:
        out = []
        while len(self._buf) >= self.block_size:
            out.append(self._enc.encode_frame(self._buf[: self.block_size]))
            self._buf = self._buf[self.block_size:]
        return out

    def configuration_data(self) -> bytes:
        return self._enc.streaminfo()

    def streaminfo_block(self) -> bytes:
        return self._enc.streaminfo_block()

    def close(self):
        pass
