"""ctypes bindings for the port's host C++ (``mixlab_native.cpp``): the
WebSocket unmask and the CAVLC intra frame encoder, the two parts of
``mixlab_tpu/native`` that the served session runs.

The library is built with ``g++`` at first use into ``mixlab_tpu_torch/_build/``
under a name that carries a hash of the source and the flags.  The build is
atomic: one process at a time builds (an exclusive ``flock`` on a lock file
beside the library), it writes to a name of its own and ``os.replace``\\ s
the result into place, and every other process waits on the lock and then
loads the finished file, so workers that start together build it once.

This is host code, not a device kernel.  Every entry point has a fallback,
as in the JAX package: ``ws_unmask`` XORs in numpy and ``h264_encode_frame``
returns ``None`` (the caller takes the numpy encoder).  ``available()`` says
which path is active.
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
    lib.ws_unmask.restype = None
    lib.ws_unmask.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p]
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


def ws_unmask(payload: bytes, mask: bytes) -> bytes:
    lib = _load()
    if lib is None:
        m = np.frombuffer((mask * (len(payload) // 4 + 1))[: len(payload)], np.uint8)
        return (np.frombuffer(payload, np.uint8) ^ m).tobytes()
    buf = np.frombuffer(bytearray(payload), dtype=np.uint8)
    lib.ws_unmask(buf.ctypes.data, buf.size, mask)
    return buf.tobytes()


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
