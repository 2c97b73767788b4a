"""The port's host C++ primitives (``mixlab_tpu_torch/native``): the SPSC
byte ring, the PCM conversions and the host crossfade, on
``tests/test_native.py``'s cases, against the JAX package's functions on the
same inputs (exact: both compute the same integer and f32 expressions)."""

import threading

import numpy as np
import pytest

from mixlab_tpu import native as jnative
from mixlab_tpu_torch import native


@pytest.fixture(scope="module", autouse=True)
def require_native():
    if not native.available():
        pytest.skip("g++ unavailable: the port's native library cannot be built")


def _ring_script(ring):
    """test_native.py's wraparound case as a log of each call's result."""
    data = bytes(range(256))
    out = [ring.capacity]
    for _ in range(3):
        out += [ring.push(data), ring.pop(256), len(ring)]
    big = b"x" * 1024
    out += [ring.push(big), ring.push(b"y"), len(ring), ring.pop(1024), ring.pop(10)]
    ring.close()
    return out


def test_ring_push_pop_wraparound():
    ring = native.NativeByteRing(1024)
    assert ring.capacity == 1024
    data = bytes(range(256))
    # fill beyond one wrap
    for _ in range(3):
        assert ring.push(data)
        assert ring.pop(256) == data
    # all-or-nothing push on full
    big = b"x" * 1024
    assert ring.push(big)
    assert not ring.push(b"y")  # full
    assert ring.pop(1024) == big
    ring.close()


@pytest.mark.parametrize("capacity", [1000, 1024])
def test_ring_matches_jax_ring(capacity):
    """Both packages' rings through the same calls (a capacity rounded up to
    a power of two, wraparound, a refused push) give the same results."""
    if not jnative.available():
        pytest.skip("the JAX package's native library is unavailable")
    assert _ring_script(native.NativeByteRing(capacity)) == _ring_script(
        jnative.NativeByteRing(capacity))


def test_ring_spsc_threads():
    ring = native.NativeByteRing(1 << 16)
    total = 4096 * 488
    chunk = 4096
    payload = np.random.default_rng(0).integers(0, 256, chunk, dtype=np.uint8).tobytes()
    received = []

    def producer():
        sent = 0
        while sent < total:
            if ring.push(payload):
                sent += chunk

    def consumer():
        got = 0
        while got < total:
            data = ring.pop(chunk)
            if data:
                received.append(data)
                got += len(data)

    t1 = threading.Thread(target=producer)
    t2 = threading.Thread(target=consumer)
    t1.start()
    t2.start()
    t1.join(10)
    t2.join(10)
    blob = b"".join(received)
    assert len(blob) == total
    for i in range(0, total, chunk):
        assert blob[i:i + chunk] == payload[:min(chunk, total - i)]
    ring.close()


def test_pcm_conversions_match_jax():
    x = np.array([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0], dtype=np.float32)
    got = native.pcm_f32_to_i16(x)
    np.testing.assert_array_equal(got, (np.clip(x, -1, 1) * 32767.0).astype(np.int16))
    np.testing.assert_array_equal(got, jnative.pcm_f32_to_i16(x))

    i = np.array([-32768, -1, 0, 1, 32767], dtype=np.int16)
    got = native.pcm_i16_to_f32(i)
    np.testing.assert_allclose(got, i.astype(np.float32) / 32768.0, rtol=0)
    np.testing.assert_array_equal(got, jnative.pcm_i16_to_f32(i))

    rng = np.random.default_rng(3)
    x = rng.uniform(-1.5, 1.5, (735, 2)).astype(np.float32)
    assert native.pcm_f32_to_i16(x).shape == (735, 2)
    np.testing.assert_array_equal(native.pcm_f32_to_i16(x), jnative.pcm_f32_to_i16(x))
    i = rng.integers(-32768, 32768, (735, 2), dtype=np.int16)
    np.testing.assert_array_equal(native.pcm_i16_to_f32(i), jnative.pcm_i16_to_f32(i))


@pytest.mark.parametrize("fade", [0, 1, 127, 200, 255])
def test_crossfade_u8_matches_jax(fade):
    rng = np.random.default_rng(2)
    a = rng.integers(0, 256, 10000, dtype=np.uint8)
    b = rng.integers(0, 256, 10000, dtype=np.uint8)
    got = native.crossfade_u8(a, b, fade)
    want = ((a.astype(np.uint32) * fade + b.astype(np.uint32) * (255 - fade)) // 255
            ).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.crossfade_u8(a, b, fade))


def test_fallbacks_without_the_library(monkeypatch):
    """Without the library the conversions and the crossfade compute the
    same in numpy, and the ring (which has no fallback) raises."""
    rng = np.random.default_rng(4)
    x = rng.uniform(-1.5, 1.5, 1000).astype(np.float32)
    i = rng.integers(-32768, 32768, 1000, dtype=np.int16)
    a, b = (rng.integers(0, 256, 1000, dtype=np.uint8) for _ in range(2))
    want = (native.pcm_f32_to_i16(x), native.pcm_i16_to_f32(i), native.crossfade_u8(a, b, 77))
    monkeypatch.setattr(native, "_load", lambda: None)
    got = (native.pcm_f32_to_i16(x), native.pcm_i16_to_f32(i), native.crossfade_u8(a, b, 77))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(RuntimeError, match="unavailable"):
        native.NativeByteRing(64)
