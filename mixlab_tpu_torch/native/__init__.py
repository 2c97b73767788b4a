"""ctypes bindings for the port's host C++ (``mixlab_native.cpp``): the
SPSC byte ring (``NativeByteRing``), the PCM conversions
(``pcm_f32_to_i16``, ``pcm_i16_to_f32``), the host crossfade
(``crossfade_u8``), the WebSocket unmask, the CAVLC intra frame encoder,
the H.264 decoders (``h264_parse_slice``, ``h264_dc_recon``,
``h264_decode_islice``, ``h264_decode_islice_cabac``,
``h264_decode_inter``) and the banded host resize (``scale_plane_banded``):
the port's copy of ``mixlab_tpu/native``.

The library is built with ``g++`` at first use into ``mixlab_tpu_torch/_build/``
under a name that carries a hash of the source and the flags.  The build is
atomic: one process at a time builds (an exclusive ``flock`` on a lock file
beside the library), it writes to a name of its own and ``os.replace``\\ s
the result into place, and every other process waits on the lock and then
loads the finished file, so workers that start together build it once.

This is host code, not a device kernel.  Every entry point has a fallback,
as in the JAX package: the PCM conversions and ``crossfade_u8`` compute in
numpy, ``NativeByteRing`` raises (it has no fallback), ``ws_unmask`` XORs in numpy, ``h264_encode_frame``
returns ``None`` (the caller takes the numpy encoder), and each decoder
returns ``None`` (or ``False``) so that the caller takes its Python tier
(``av/h264dec_fast.py``, ``av/h264cabac.py``, ``av/h264dec.py``), and
``scale_plane_banded`` returns ``None`` (the caller takes numpy).
``available()`` says which path is active.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "mixlab_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# no -march=native: the library stays loadable on another host of the same
# architecture; the encoder's output does not depend on the flags
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libmixlab_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``mixlab_native.cpp`` unless the library for the current
    source exists; raises ``RuntimeError`` when ``g++`` fails or is absent."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(path.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if path.exists():  # another process built it while this one waited
            return path
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        try:
            proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                                  capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ could not build {_SRC.name}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on {_SRC.name}:\n{proc.stderr}")
        os.replace(tmp, path)  # atomic: no process ever loads half a file
    return path


def _load() -> Optional[ctypes.CDLL]:
    """The library, built at the first call; ``None`` (logged once) when it
    cannot be built or loaded."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError) as e:
        log.info("native library unavailable: %s", e)
        return None
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_uint64]
    lib.ring_destroy.restype = None
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ring_size.restype = ctypes.c_uint64
    lib.ring_size.argtypes = [ctypes.c_void_p]
    lib.ring_capacity.restype = ctypes.c_uint64
    lib.ring_capacity.argtypes = [ctypes.c_void_p]
    lib.ring_push.restype = ctypes.c_uint64
    lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.ring_pop.restype = ctypes.c_uint64
    lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    lib.pcm_f32_to_i16.restype = None
    lib.pcm_f32_to_i16.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    lib.pcm_i16_to_f32.restype = None
    lib.pcm_i16_to_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    lib.crossfade_u8.restype = None
    lib.crossfade_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_uint64, ctypes.c_uint8,
    ]
    lib.ws_unmask.restype = None
    lib.ws_unmask.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p]
    lib.h264_parse_slice.restype = ctypes.c_int64
    lib.h264_parse_slice.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
    ] + [ctypes.c_void_p] * 8
    lib.h264_dc_recon.restype = None
    lib.h264_dc_recon.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int64] * 4
        + [ctypes.c_void_p] * 3
    )
    lib.h264_decode_islice.restype = ctypes.c_int64
    lib.h264_decode_islice.argtypes = (
        [ctypes.c_char_p]               # data (padded RBSP)
        + [ctypes.c_int64] * 10         # n_bytes..off_b
        + [ctypes.c_char_p]             # tables
        + [ctypes.c_void_p] * 4         # ry, ru, rv, out_state
    )
    lib.h264_decode_islice_cabac.restype = ctypes.c_int64
    lib.h264_decode_islice_cabac.argtypes = (
        [ctypes.c_char_p]               # data (padded RBSP)
        + [ctypes.c_int64] * 10         # n_bytes..off_b
        + [ctypes.c_char_p]             # cabac tables blob
        + [ctypes.c_void_p] * 4         # ry, ru, rv, out_state
    )
    lib.h264_decode_inter.restype = ctypes.c_int64
    lib.h264_decode_inter.argtypes = (
        [ctypes.c_char_p]               # data (padded RBSP)
        + [ctypes.c_int64] * 2          # n_bytes, start_pos
        + [ctypes.c_void_p]             # cfg (int64[20])
        + [ctypes.c_void_p] * 3         # refs_y/u/v
        + [ctypes.c_void_p] * 6         # slot/pid/poc for list0, list1
        + [ctypes.c_void_p] * 4         # col mv/ridx/rpid/rpoc
        + [ctypes.c_int64]              # has_wp
        + [ctypes.c_void_p]             # wp
        + [ctypes.c_char_p] * 2         # cavlc tables, cabac blob
        + [ctypes.c_void_p] * 3         # ry, ru, rv
        + [ctypes.c_void_p] * 4         # mv/ridx/rpid/rpoc motion export
        + [ctypes.c_void_p]             # out_state
    )
    lib.scale_plane_banded.restype = None
    lib.scale_plane_banded.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.h264_encode_frame.restype = ctypes.c_int64
    lib.h264_encode_frame.argtypes = (
        [ctypes.c_void_p] * 3           # py, pu, pv
        + [ctypes.c_int64] * 4          # mbw, mbh, qp, qpc
        + [ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint64, ctypes.c_int64]
        + [ctypes.c_void_p]             # tables
        + [ctypes.c_void_p, ctypes.c_int64]  # out, out_cap
        + [ctypes.c_void_p] * 3         # recon planes
    )
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class NativeByteRing:
    """Lock-free SPSC byte ring (C++); capacity rounded up to a power of 2."""

    def __init__(self, capacity: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        cap = 1
        while cap < capacity:
            cap <<= 1
        self._lib = lib
        self._ptr = lib.ring_create(cap)
        if not self._ptr:
            raise MemoryError("ring_create failed")

    def push(self, data: bytes) -> bool:
        return self._lib.ring_push(self._ptr, data, len(data)) == len(data)

    def pop(self, n: int) -> bytes:
        buf = ctypes.create_string_buffer(n)
        got = self._lib.ring_pop(self._ptr, buf, n)
        return buf.raw[:got]

    def __len__(self) -> int:
        return self._lib.ring_size(self._ptr)

    @property
    def capacity(self) -> int:
        return self._lib.ring_capacity(self._ptr)

    def close(self):
        if self._ptr:
            self._lib.ring_destroy(self._ptr)
            self._ptr = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def pcm_f32_to_i16(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32)
    lib = _load()
    if lib is None:
        return (np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)
    out = np.empty(x.shape, dtype=np.int16)
    lib.pcm_f32_to_i16(x.ctypes.data, out.ctypes.data, x.size)
    return out


def pcm_i16_to_f32(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.int16)
    lib = _load()
    if lib is None:
        return x.astype(np.float32) / 32768.0
    out = np.empty(x.shape, dtype=np.float32)
    lib.pcm_i16_to_f32(x.ctypes.data, out.ctypes.data, x.size)
    return out


def crossfade_u8(a: np.ndarray, b: np.ndarray, fade: int) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.uint8)
    b = np.ascontiguousarray(b, dtype=np.uint8)
    lib = _load()
    if lib is None:
        acc = a.astype(np.uint32) * fade + b.astype(np.uint32) * (255 - fade)
        return (acc // 255).astype(np.uint8)
    out = np.empty(a.shape, dtype=np.uint8)
    lib.crossfade_u8(a.ctypes.data, b.ctypes.data, out.ctypes.data, a.size, fade)
    return out


def ws_unmask(payload: bytes, mask: bytes) -> bytes:
    lib = _load()
    if lib is None:
        m = np.frombuffer((mask * (len(payload) // 4 + 1))[: len(payload)], np.uint8)
        return (np.frombuffer(payload, np.uint8) ^ m).tobytes()
    buf = np.frombuffer(bytearray(payload), dtype=np.uint8)
    lib.ws_unmask(buf.ctypes.data, buf.size, mask)
    return buf.tobytes()


def h264_parse_slice(padded: bytes, n_bytes: int, start_pos: int,
                     first_mb: int, mbw: int, mbh: int, qp: int,
                     tables: bytes, kinds: np.ndarray, qps: np.ndarray,
                     l_dc: np.ndarray, l_ac: np.ndarray, c_dc: np.ndarray,
                     c_ac: np.ndarray, pcm: np.ndarray,
                     out_state: np.ndarray) -> Optional[int]:
    """CAVLC pass-1 slice parse (see mixlab_native.cpp); fills the
    preallocated coefficient arrays in place.  Returns the C error code
    (0 = ok), or None when the native library is unavailable (the caller
    falls back to the Python parse in av/h264dec_fast.py)."""
    lib = _load()
    if lib is None:
        return None
    return int(lib.h264_parse_slice(
        padded, n_bytes, start_pos, first_mb, mbw, mbh, qp, tables,
        kinds.ctypes.data, qps.ctypes.data, l_dc.ctypes.data,
        l_ac.ctypes.data, c_dc.ctypes.data, c_ac.ctypes.data,
        pcm.ctypes.data, out_state.ctypes.data))


def h264_dc_recon(mb_y: np.ndarray, mb_c: np.ndarray, kinds: np.ndarray,
                  pcm: np.ndarray, first_mb: int, mbw: int, mbh: int,
                  ry: np.ndarray, ru: np.ndarray, rv: np.ndarray) -> bool:
    """Sequential DC-prediction reconstruction into the decoder's planes
    (see mixlab_native.cpp).  Returns False when the native library is
    unavailable (caller falls back to the Python wavefront)."""
    lib = _load()
    if lib is None:
        return False
    lib.h264_dc_recon(
        mb_y.ctypes.data, mb_c.ctypes.data, kinds.ctypes.data,
        pcm.ctypes.data, len(kinds), first_mb, mbw, mbh,
        ry.ctypes.data, ru.ctypes.data, rv.ctypes.data)
    return True


def h264_decode_islice(padded: bytes, n_bytes: int, start_pos: int,
                       mbw: int, mbh: int, slice_qp: int,
                       chroma_qp_off: int, chroma_qp_off2: int,
                       disable_idc: int, off_a: int, off_b: int,
                       tables: bytes, ry: np.ndarray, ru: np.ndarray,
                       rv: np.ndarray,
                       out_state: np.ndarray) -> Optional[int]:
    """FULL baseline-intra slice decode: macroblock layer + deblocking into
    the uint8 planes (see mixlab_native.cpp h264_decode_islice).  Returns
    the C error code (0 = ok), or None when the native library is
    unavailable (caller falls back to the Python tiers)."""
    lib = _load()
    if lib is None:
        return None
    return int(lib.h264_decode_islice(
        padded, n_bytes, start_pos, mbw, mbh, slice_qp,
        chroma_qp_off, chroma_qp_off2, disable_idc, off_a, off_b, tables,
        ry.ctypes.data, ru.ctypes.data, rv.ctypes.data,
        out_state.ctypes.data))


def h264_decode_islice_cabac(padded: bytes, n_bytes: int, start_pos: int,
                             mbw: int, mbh: int, slice_qp: int,
                             chroma_qp_off: int, chroma_qp_off2: int,
                             disable_idc: int, off_a: int, off_b: int,
                             cabac_tables: bytes, ry: np.ndarray,
                             ru: np.ndarray, rv: np.ndarray,
                             out_state: np.ndarray) -> Optional[int]:
    """Full intra CABAC slice decode (see mixlab_native.cpp
    h264_decode_islice_cabac).  Returns the C error code (0 = ok), or
    None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    return int(lib.h264_decode_islice_cabac(
        padded, n_bytes, start_pos, mbw, mbh, slice_qp,
        chroma_qp_off, chroma_qp_off2, disable_idc, off_a, off_b,
        cabac_tables, ry.ctypes.data, ru.ctypes.data, rv.ctypes.data,
        out_state.ctypes.data))


def h264_decode_inter(padded: bytes, n_bytes: int, start_pos: int,
                      cfg: np.ndarray, refs_y: np.ndarray,
                      refs_u: np.ndarray, refs_v: np.ndarray,
                      ref_slot0: np.ndarray, ref_pid0: np.ndarray,
                      ref_poc0: np.ndarray, ref_slot1: np.ndarray,
                      ref_pid1: np.ndarray, ref_poc1: np.ndarray,
                      col_mv: Optional[np.ndarray],
                      col_ridx: Optional[np.ndarray],
                      col_rpid: Optional[np.ndarray],
                      col_rpoc: Optional[np.ndarray],
                      wp: Optional[np.ndarray], cavlc_tables: bytes,
                      cabac_blob: bytes, ry: np.ndarray, ru: np.ndarray,
                      rv: np.ndarray, mv_out: np.ndarray,
                      ridx_out: np.ndarray, rpid_out: np.ndarray,
                      rpoc_out: np.ndarray,
                      out_state: np.ndarray) -> Optional[int]:
    """P/B-slice decode (CAVLC or CABAC): macroblock layer, MC + direct
    prediction and deblocking into the uint8 planes (mixlab_native.cpp
    h264_decode_inter).  ``cfg`` is the int64[20] config block (see the
    C entry); refs_y/u/v are stacked full reference planes; the
    slot/pid/poc triples map each list's entries; col_* is the
    co-located motion of RefPicList1[0] (B direct); the per-4x4 motion
    field exports into mv/ridx/rpid/rpoc_out for DPB storage.  Returns
    the C error code (0 = ok) or None when the native library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None

    def ptr(a):
        return None if a is None else a.ctypes.data

    return int(lib.h264_decode_inter(
        padded, n_bytes, start_pos, cfg.ctypes.data,
        refs_y.ctypes.data, refs_u.ctypes.data, refs_v.ctypes.data,
        ref_slot0.ctypes.data, ref_pid0.ctypes.data, ref_poc0.ctypes.data,
        ref_slot1.ctypes.data, ref_pid1.ctypes.data, ref_poc1.ctypes.data,
        ptr(col_mv), ptr(col_ridx), ptr(col_rpid), ptr(col_rpoc),
        0 if wp is None else 1, ptr(wp),
        cavlc_tables, cabac_blob,
        ry.ctypes.data, ru.ctypes.data, rv.ctypes.data,
        mv_out.ctypes.data, ridx_out.ctypes.data, rpid_out.ctypes.data,
        rpoc_out.ctypes.data, out_state.ctypes.data))


def h264_encode_frame(py: np.ndarray, pu: np.ndarray, pv: np.ndarray,
                      mbw: int, mbh: int, qp: int, qpc: int,
                      hdr_bytes: bytes, hdr_acc: int, hdr_nbits: int,
                      tables: np.ndarray, recon_y: np.ndarray,
                      recon_u: np.ndarray, recon_v: np.ndarray
                      ) -> Optional[bytes]:
    """Full-frame CAVLC Intra_16x16 encode (see mixlab_native.cpp) —
    byte-identical to CavlcIntraEncoder.encode_frame.  Planes must be
    C-contiguous uint8, MB-padded; recon planes are filled in place.
    Returns the slice RBSP, or None when the native library is unavailable
    (the caller falls back to the vectorized numpy encoder)."""
    lib = _load()
    if lib is None:
        return None
    cap = 4096 * mbw * mbh + len(hdr_bytes) + 1024
    out = np.empty(cap, np.uint8)
    n = lib.h264_encode_frame(
        py.ctypes.data, pu.ctypes.data, pv.ctypes.data, mbw, mbh, qp, qpc,
        hdr_bytes, len(hdr_bytes), hdr_acc, hdr_nbits, tables.ctypes.data,
        out.ctypes.data, cap,
        recon_y.ctypes.data, recon_u.ctypes.data, recon_v.ctypes.data)
    if n < 0:
        raise RuntimeError("h264_encode_frame: output buffer overflow")
    return out[:n].tobytes()


def scale_plane_banded(plane: np.ndarray, out_h: int, out_w: int,
                       yidx: np.ndarray, yw: np.ndarray,
                       xidx: np.ndarray, xw: np.ndarray) -> Optional[np.ndarray]:
    """Banded separable resize of a u8 plane (weights packed by
    ``video/scale_host.py`` from ``video/scale.py``'s resize_matrix).
    Returns None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    plane = np.ascontiguousarray(plane, dtype=np.uint8)
    yidx, xidx = (np.ascontiguousarray(a, np.int32) for a in (yidx, xidx))
    yw, xw = (np.ascontiguousarray(a, np.float32) for a in (yw, xw))
    out = np.empty((out_h, out_w), dtype=np.uint8)
    tmp = np.empty(plane.shape[1], dtype=np.float32)
    lib.scale_plane_banded(
        plane.ctypes.data, plane.shape[0], plane.shape[1],
        out.ctypes.data, out_h, out_w,
        yidx.ctypes.data, yw.ctypes.data, yidx.shape[1],
        xidx.ctypes.data, xw.ctypes.data, xidx.shape[1],
        tmp.ctypes.data)
    return out
