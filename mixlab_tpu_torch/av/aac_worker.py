"""The AAC-LC codec process behind ``av/codecs.py`` ``PureAacStream``.

Run as ``python -m mixlab_tpu_torch.av.aac_worker RATE CHANNELS QUALITY
BITRATE`` (``BITRATE`` 0 for the VBR quality mode).  It reads interleaved
s16le PCM on stdin and writes one ADTS frame to stdout for every whole
1,024-sample granule, flushed at once; it exits at the end of stdin.  The
frames are those of ``AacLcEncoder`` in the calling process, byte for
byte: the encoder is the same and sees the same granules in the same order.

It imports numpy and the encoder's modules only: not torch, so nothing here
touches a device, and it starts in a fraction of a second.
"""

from __future__ import annotations

import sys

import numpy as np

from mixlab_tpu_torch.av.aac import adts_frame
from mixlab_tpu_torch.av.aacenc import AacLcEncoder

GRANULE = 1024  # samples per channel in one AAC-LC frame


def main(argv=None) -> int:
    rate, channels, quality, bitrate = (int(a) for a in (argv or sys.argv[1:]))
    enc = AacLcEncoder(rate, channels, quality=quality, bitrate=bitrate or None)
    step = GRANULE * channels * 2
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    buf = bytearray()
    while True:
        data = stdin.read1(1 << 16)
        if not data:
            return 0
        buf += data
        n = len(buf) // step
        if n:
            pcm = np.frombuffer(bytes(buf[:n * step]), "<i2").reshape(n, GRANULE, channels)
            del buf[:n * step]
            stdout.write(b"".join(adts_frame(enc.encode_granule(g), enc.asc) for g in pcm))
            stdout.flush()


if __name__ == "__main__":
    sys.exit(main())
