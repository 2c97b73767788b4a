"""The AAC-LC decode codec process, and ``AacDecodeProcess``, its handle.

Run as ``python -m mixlab_tpu_torch.av.aacdec_worker ASC_HEX``: the child
holds one ``AacLcDecoder`` made from the stream's AudioSpecificConfig for
the stream's life, so its state (the filterbank's overlap carry, the noise
generator) carries from granule to granule exactly as the in-process
decoder's does.  It reads records on stdin and answers each one on stdout,
flushed at once; it exits at the end of stdin.

    request:  <u32 payload length> <u8 sampling frequency index> payload
    reply:    <u8 kind> <u32 a> <u32 b> body
              kind 0, PCM:   a rows, b channels, body a*b f32 (little endian)
              kind 1, AacDecodeError: a bytes of its message (UTF-8)
              kind 2, any other exception: a bytes of "Type: message"

It imports numpy and the decoder's modules only: not torch, so nothing here
touches a device, and it starts in a fraction of a second.  The decode is
the same code on the same granules in the same order as in the calling
process, so its PCM is the in-process decoder's, bit for bit.
"""

from __future__ import annotations

import struct
import sys
import weakref

import numpy as np

_REQUEST = struct.Struct("<IB")
_REPLY = struct.Struct("<BII")
PCM, DECODE_ERROR, OTHER_ERROR = 0, 1, 2


def _read_exactly(stream, n: int) -> bytes:
    """``n`` bytes from a pipe, or fewer at its end (a read of a pipe
    waits in the OS, the interpreter lock released)."""
    data = stream.read(n)
    while data is not None and 0 < len(data) < n:
        more = stream.read(n - len(data))
        if not more:
            break
        data += more
    return data or b""


def main(argv=None) -> int:
    from mixlab_tpu_torch.av.aac import AudioSpecificConfiguration
    from mixlab_tpu_torch.av.aacdec import AacDecodeError, AacLcDecoder

    (asc_hex,) = argv or sys.argv[1:]
    dec = AacLcDecoder(AudioSpecificConfiguration.parse(bytes.fromhex(asc_hex)))
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    while True:
        head = _read_exactly(stdin, _REQUEST.size)
        if len(head) < _REQUEST.size:
            return 0
        n, sfi = _REQUEST.unpack(head)
        payload = _read_exactly(stdin, n)
        if len(payload) < n:
            return 0
        try:
            pcm = np.ascontiguousarray(dec.decode_raw(payload, sfi), "<f4")
        except AacDecodeError as e:
            msg = str(e).encode()
            stdout.write(_REPLY.pack(DECODE_ERROR, len(msg), 0) + msg)
        except Exception as e:  # noqa: BLE001 - handed to the caller, typed by name
            msg = f"{type(e).__name__}: {e}".encode()
            stdout.write(_REPLY.pack(OTHER_ERROR, len(msg), 0) + msg)
        else:
            stdout.write(_REPLY.pack(PCM, pcm.shape[0], pcm.shape[1]) + pcm.tobytes())
        stdout.flush()


class AacDecodeProcess:
    """``AacLcDecoder`` with its decode in a codec process: the same
    ``decode_raw(payload, sfi)`` and the same PCM, bit for bit, or the same
    ``AacDecodeError`` for a granule the decoder refuses.  A call writes the
    granule to the child and waits for its reply on the pipe, the
    interpreter lock released, so the calling thread takes no time from the
    engine thread while the child decodes.  Another exception in the child
    raises ``RuntimeError`` naming it; a child that has exited raises
    ``RuntimeError``.  ``close`` ends the child (as does collection)."""

    def __init__(self, asc):
        from mixlab_tpu_torch.av import codec_process

        self.asc = asc
        self.proc = codec_process.spawn("mixlab_tpu_torch.av.aacdec_worker",
                                        asc.to_bytes().hex())
        self._closer = weakref.finalize(self, codec_process.end_process, self.proc)

    def decode_raw(self, payload: bytes, sfi: int) -> np.ndarray:
        from mixlab_tpu_torch.av.aacdec import AacDecodeError

        try:
            self.proc.stdin.write(_REQUEST.pack(len(payload), sfi) + bytes(payload))
            self.proc.stdin.flush()
        except (BrokenPipeError, ValueError) as e:
            raise RuntimeError(
                f"the AAC decode process has exited (code {self.proc.poll()})") from e
        head = _read_exactly(self.proc.stdout, _REPLY.size)
        if len(head) < _REPLY.size:
            raise RuntimeError(
                f"the AAC decode process has exited (code {self.proc.wait()})")
        kind, a, b = _REPLY.unpack(head)
        want = a * b * 4 if kind == PCM else a
        body = _read_exactly(self.proc.stdout, want)
        if len(body) < want:
            raise RuntimeError(
                f"the AAC decode process has exited (code {self.proc.wait()})")
        if kind == PCM:
            return np.frombuffer(body, "<f4").reshape(a, b).astype(np.float32)
        if kind == DECODE_ERROR:
            raise AacDecodeError(body.decode())
        raise RuntimeError(f"the AAC decode process failed: {body.decode()}")

    def close(self):
        """End the child (stdin closed, waited for, killed if it lingers)."""
        self._closer()


if __name__ == "__main__":
    sys.exit(main())
