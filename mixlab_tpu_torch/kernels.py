"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``), one process per
source, all started together, and linked into one shared library with a
plain C interface, loaded with ``ctypes.CDLL``: a call releases the GIL
while the C entry point runs, as PyTorch's own bindings do, so a launch that
blocks in the driver (a full launch queue, a module's first load) does not
hold up the process's other Python threads, the realtime engine's tick and
feeder among them (``ctypes.PyDLL`` keeps the GIL; ``PERF.md`` compares the
two calls' host time).  The library is built at first use into ``mixlab_tpu_torch/_build/`` (listed in ``.gitignore``) under a
name that carries a hash of the sources and flags, so a changed source is
rebuilt and a fresh checkout builds on its own.  A
missing ``nvcc`` or a failed build raises; nothing falls back to the plain
PyTorch versions.

Every wrapper launches through ``launch``, the port's one host path to a
kernel: the C entry point is looked up once and kept, the stream is the raw
handle of PyTorch's current stream (no ``Stream`` object), and the C side
(``csrc/on_device.cuh``) makes the tensors' card current only when it is not
already.  The wrappers write their checks inline, ``if not ...: raise
ValueError(f"...")``, so a message is built only when its check fails.

Deliberately absent flags: ``--use_fast_math`` (the envelope relies on IEEE
division by zero and NaN propagation, the eq on IEEE f32 rounding).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *_ARCH,
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # no contraction of a*b + c into one FMA unless the source says fmaf:
    # each operation rounds as the plain PyTorch twins' separate ops do, so
    # the envelope matches its twin bit for bit on the flagship's gate
    "-fmad=false",
    "-Xptxas", "-v",  # registers / spills per kernel, kept in the build log
)

_c_ptr = ctypes.c_void_p
_c_int = ctypes.c_int
_c_llong = ctypes.c_longlong
_c_float = ctypes.c_float
_c_uint = ctypes.c_uint

# C entry points: name -> argtypes (every function returns a cudaError_t int);
# each ends with the card's index and the stream, which ``launch`` appends
_SIGNATURES = {
    "mixlab_envelope_block": [
        _c_ptr, _c_ptr, _c_int,                  # x, out, S
        _c_int, _c_int,                          # batch, form
        _c_int, _c_int, _c_int,                  # lane, tiles, CTAs (look-back)
        _c_ptr,                                  # scratch
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_float,  # attack..release, msps
        _c_ptr, _c_ptr, _c_ptr, _c_ptr,          # state in
        _c_ptr, _c_ptr, _c_ptr, _c_ptr,          # state out
        _c_int, _c_ptr,                          # device, stream
    ],
    "mixlab_eq_cascade": [
        _c_ptr, _c_ptr, _c_int, _c_int, _c_int,          # x, xd, S, batch, form
        _c_ptr, _c_ptr, _c_ptr,                          # poles0, gains, tables
        _c_float, _c_float, _c_float,                    # f_lo, f_hi, vsa
        _c_int, _c_int, _c_int, _c_int,                  # run, threads, tiles, CTAs
        _c_ptr, _c_ptr, _c_ptr,                          # scratch, out, poles_out
        _c_int, _c_ptr,                                  # device, stream
    ],
    "mixlab_region_part": [
        _c_ptr, _c_int, _c_ptr, _c_int, _c_int,  # ops, n_words, slots, n_operands, n_slots
        _c_ptr, _c_llong, _c_int, _c_ptr,        # pf, pf_stride, n_pf, consts
        _c_ptr, _c_llong,                        # sf, sf_stride
        _c_ptr, _c_int, _c_ptr, _c_int,          # taps, n_taps, stap, n_stap
        _c_ptr, _c_int,                          # ef, n_ef
        _c_int, _c_int, _c_int, _c_int, _c_int,  # S, batch, form, run, tiles
        _c_int, _c_int, _c_uint,                 # CTAs (look-back), n_eq, i16 mask
        _c_ptr,                                  # scratch
        _c_int, _c_ptr,                          # device, stream
    ],
    "mixlab_crossfade": [
        *[_c_ptr, _c_ptr, _c_ptr, _c_int] * 3,  # (a, b, out, n) per plane
        _c_int, _c_int, _c_int, _c_ptr,          # count, fade, device, stream
    ],
    "mixlab_resize_picture": [
        *[_c_ptr, _c_ptr] * 3,            # (x, out) per plane
        _c_int, _c_ptr, _c_ptr,           # planes, host table, device table
        _c_int, _c_int, _c_int, _c_int,   # tiles, plane 1's and 2's first, shared bytes
        _c_int, _c_ptr,                   # device, stream
    ],
    "mixlab_passthrough": [_c_ptr, _c_ptr, _c_int, _c_int, _c_ptr],  # x, out, n, device, stream
}

# queries, called directly (no stream): name -> argtypes
_QUERIES = {
    "mixlab_envelope_resident_tiles": [_c_int, _c_ptr],  # device, int* resident
    "mixlab_eq_resident_tiles": [_c_int, _c_int, _c_ptr],  # threads, device, int* resident
    "mixlab_eq_rows_resident": [_c_int, _c_ptr],  # device, int* resident
    "mixlab_region_resident_tiles": [_c_int, _c_ptr],  # device, int* resident
    # form, lg, device, int* resident
    "mixlab_envelope_rows_resident": [_c_int, _c_int, _c_int, _c_ptr],
    # form, run, n_operands, n_scratch, n_eq, device, int* resident
    "mixlab_region_rows_resident": [_c_int] * 6 + [_c_ptr],
}


def sources():
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH, $CUDA_HOME/bin, "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and the header they share
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmixlab_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/`` unless a library for the current sources exists:
    one ``nvcc -c`` per source in parallel, then one link.  The compiler's
    messages (``-Xptxas -v``) go to ``<library>.log``."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    t = time.perf_counter()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        results = [(c, p.communicate(timeout=900)[0], p.returncode)
                   for c, p in zip(cmds, procs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if all(rc == 0 for _, _, rc in results):
        link = [nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True, timeout=300)
        results.append((link, proc.stdout + proc.stderr, proc.returncode))
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "".join(f"$ {' '.join(c)}\n{out}rc={rc}\n" for c, out, rc in results)
    path.with_suffix(".log").write_text(
        log + f"seconds={time.perf_counter() - t:.2f}\n")
    if any(rc != 0 for _, _, rc in results):  # a failed compile skips the link
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{log}")
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    return path


_load_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declares every C
    entry point's argument and return types.  Once a process: the first
    caller builds while any other thread (the engine's and its compile
    worker, say) waits, since ``build`` names its files by process."""
    with _load_lock:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in {**_SIGNATURES, **_QUERIES}.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _c_int
    lib.mixlab_cuda_error_string.argtypes = [_c_int]
    lib.mixlab_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.mixlab_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def query(name: str, what: str, *args) -> int:
    """Call the C query ``name`` with ``args`` and an int out-parameter and
    return the int; raise ``RuntimeError`` naming ``what`` on a CUDA error."""
    lib = load()
    n = ctypes.c_int(0)
    check(lib, getattr(lib, name)(*args, ctypes.byref(n)), what)
    return n.value


def cuda_index(t, what: str) -> int:
    """The card index of the CUDA tensor ``t``; for anything else a
    ``ValueError`` "<what>: unsupported device ..." (no fallback)."""
    if isinstance(t, torch.Tensor) and t.is_cuda:
        return t.get_device()
    raise ValueError(f"{what}: unsupported device {getattr(t, 'device', type(t))}")


_entries: dict = {}  # C entry point name -> ctypes function, kept after the first call
_raw_stream = None   # torch._C._cuda_getCurrentRawStream, bound at the first launch


def _entry(name: str):
    """Look up the C entry point ``name`` and keep it; bind the stream
    getter, which exists only in a CUDA build of PyTorch."""
    global _raw_stream
    _raw_stream = torch._C._cuda_getCurrentRawStream
    fn = _entries[name] = getattr(load(), name)
    return fn


def is_batched(*ts) -> bool:
    """Whether any of ``ts`` is a ``torch.func.vmap`` batched tensor (whose
    data pointer a kernel cannot take: the wrapper then goes through its
    custom op's batching rule)."""
    return any(torch._C._functorch.is_batchedtensor(t) for t in ts)


def batch_first(batch_size: int, in_dims, *ts):
    """A vmap batching rule's tensors with the batch axis first (an unbatched
    one expanded to the batch), contiguous."""
    return [(t.movedim(d, 0) if d is not None else t.expand(batch_size, *t.shape)).contiguous()
            for t, d in zip(ts, in_dims)]


def launch(name: str, what: str, index: int, *args) -> None:
    """Call the C entry point ``name`` with ``args``, card ``index`` and the
    raw handle of that card's current stream (the C side launches there);
    raise ``RuntimeError`` naming ``what`` if it returns a CUDA error."""
    fn = _entries.get(name) or _entry(name)
    rc = fn(*args, index, _raw_stream(index))
    if rc:
        check(load(), rc, what)


# the look-back forms' status scratch (csrc/rows.cuh): (kernel, card, stream
# handle) -> a zeroed scratch; the launch's number lives in its header on the
# device.  ``status_lock`` guards the table and a wrapper's path from the
# scratch to its launch.  A scratch that a captured CUDA graph launches on
# stays in ``_captured_status`` (by address) until the process ends.
_status: dict = {}
_captured_status: dict = {}
status_lock = threading.Lock()


def status_scratch(kernel: str, index: int, nbytes: int) -> torch.Tensor:
    """A status scratch of at least ``nbytes`` for a look-back launch of
    ``kernel`` on card ``index`` (``csrc/rows.cuh``), kept for the kernel,
    card and current stream and zeroed once when made (grown to a power of
    two, zeroed anew), so no launch clears it.  The launch reads its number
    from the scratch's header and the launch that ends advances it, so
    nothing here counts launches: a launch captured into a CUDA graph counts
    on at every replay, and a refused launch advances nothing.

    While the stream captures a CUDA graph the scratch must already exist at
    its size (a call on the capturing stream before the capture, as a
    capture's warm-up makes): a scratch made in the capture would be zeroed
    only when the graph replays.  The graph keeps the scratch's address, so
    the scratch is kept alive after a regrow.  The graph's launches and the
    stream's eager ones share the header, so graphs captured on one stream
    must replay in that stream's order with its other look-back launches
    (on that stream, or on one that waits for it).  Call it, and launch,
    under ``status_lock``."""
    key = (kernel, index, torch._C._cuda_getCurrentRawStream(index))
    scratch = _status.get(key)
    capturing = torch.cuda.is_current_stream_capturing()
    if scratch is None or scratch.numel() < nbytes:
        if capturing:
            raise RuntimeError(
                f"{kernel}: a look-back launch captured into a CUDA graph needs its status "
                f"scratch of {nbytes} bytes from a call on the capturing stream before the "
                "capture")
        scratch = _status[key] = _zeros(1 << max(nbytes - 1, 1).bit_length(), index)
    if capturing:
        _captured_status[scratch.data_ptr()] = scratch
    return scratch


def _zeros(nbytes: int, index: int) -> torch.Tensor:
    return torch.zeros(nbytes, dtype=torch.uint8, device=torch.device("cuda", index))
