"""Checkpoint blob codec for live migration: the part of
``mixlab_tpu/server/fleet.py`` that the server's ``/_checkpoint`` and
``/_restore`` routes use (``encode_checkpoint`` / ``decode_checkpoint``).

The blob is the JAX package's npz layout (``tick``, ``n`` and the DSP state
leaves ``s0..s{n-1}``), so a checkpoint taken by either package's server
restores into the other's.  The rest of the fleet (controller, host agents,
placement) waits for its ROADMAP.md items (queue 1, Fleet serving).
"""

from __future__ import annotations

import io

import numpy as np


def encode_checkpoint(ckpt: dict) -> bytes:
    arrays = {f"s{i}": np.asarray(a) for i, a in enumerate(ckpt["dsp_state"])}
    bio = io.BytesIO()
    np.savez(bio, tick=np.int64(ckpt.get("tick", 0)),
             n=np.int64(len(arrays)), **arrays)
    return bio.getvalue()


def decode_checkpoint(blob: bytes) -> dict:
    z = np.load(io.BytesIO(blob), allow_pickle=False)
    n = int(z["n"])
    return {
        "tick": int(z["tick"]),
        "dsp_state": [z[f"s{i}"] for i in range(n)],
    }
