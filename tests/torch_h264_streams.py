"""The x264 test streams under ``tests/data/h264/``: what each one is and how
it is made.

Each stream is Annex B: x264's extradata (SPS and PPS) followed by its
packets in decode order.  They are made by the JAX package's libavcodec
shim (``mixlab_tpu.native.avshim.VideoEncoder``, libx264 with one thread, so
the bytes do not depend on the host's cores) from seeded numpy content, and
committed so that the card host, which has no x264, can hold the port's
native decode tier to its Python tier on third-party streams.

    python -m tests.torch_h264_streams   # rewrites tests/data/h264/*.264
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "data" / "h264"

# name -> (width, height, x264 options, frames): each class of stream the
# decoders route differently (CAVLC and CABAC, P and B, the High profile's
# 8x8 transform)
STREAMS = {
    "cavlc_p": (128, 96, "preset=veryfast,profile=baseline,tune=zerolatency,"
                "g=250,threads=1,qp=30", 6),
    "cabac_p": (96, 64, "preset=veryfast,profile=main,tune=zerolatency,"
                "g=250,threads=1,qp=30", 6),
    "cavlc_b": (112, 80, "preset=veryfast,profile=main,g=250,threads=1,"
                "x264-params=cabac=0:scenecut=0:bframes=2:b-adapt=0,qp=30", 7),
    "cabac_b": (96, 64, "preset=veryfast,profile=main,g=250,threads=1,"
                "x264-params=scenecut=0:bframes=3:b-adapt=0,qp=30", 7),
    "high_8x8": (176, 144, "preset=veryfast,profile=high,g=250,threads=1,"
                 "x264-params=scenecut=0:bframes=0,qp=28", 4),
}


def content(w: int, h: int, n: int, seed: int = 0):
    """A pan over seeded smooth texture with a little noise, so that x264
    emits fractional motion, skips and residuals in a few KB."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h * 2, 0:w * 2].astype(np.float64)
    base = (128 + 60 * np.sin(xx / 7.0) * np.cos(yy / 5.0) + 30 * np.sin((xx + yy) / 11.0)
            + rng.integers(0, 12, (h * 2, w * 2)))
    base = np.clip(base, 0, 255).astype(np.uint8)
    cu = (128 + 40 * np.sin(xx[:h, :w] / 9.0)).astype(np.uint8)
    cv = (128 + 40 * np.cos(yy[:h, :w] / 6.0)).astype(np.uint8)
    frames = []
    for i in range(n):
        oy, ox = 3 * i, 2 * i
        frames.append((base[oy:oy + h, ox:ox + w].copy(),
                       cu[oy // 2:oy // 2 + h // 2, ox // 2:ox // 2 + w // 2].copy(),
                       cv[oy // 2:oy // 2 + h // 2, ox // 2:ox // 2 + w // 2].copy()))
    return frames


def encode(name: str) -> bytes:
    """The stream ``name`` made afresh by the JAX package's x264 shim."""
    from mixlab_tpu.native import avshim

    w, h, opts, n = STREAMS[name]
    enc = avshim.VideoEncoder(w, h, fps=30, opts=opts)
    for i, (y, u, v) in enumerate(content(w, h, n)):
        enc.send(y, u, v, i)
    enc.flush()
    packets = enc.receive()
    extradata = enc.extradata()
    enc.close()
    return extradata + b"".join(data for _pts, _dts, _key, data in packets)


def load(name: str) -> bytes:
    return (DATA / f"{name}.264").read_bytes()


if __name__ == "__main__":
    DATA.mkdir(parents=True, exist_ok=True)
    for name in STREAMS:
        data = encode(name)
        (DATA / f"{name}.264").write_bytes(data)
        print(f"{name}: {len(data)} bytes")
