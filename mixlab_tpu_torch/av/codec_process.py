"""Start and end the pure tier's codec processes (``av/aac_worker.py``,
``av/aacdec_worker.py``).

A codec process runs ``python -m <module>`` with the repo root first on
``PYTHONPATH``: a new interpreter, never a fork of the calling process,
which may hold a CUDA context.  It talks over its stdin and stdout pipes and
ends at the end of its stdin.  This module imports the standard library
only, so a worker can import it as well.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])


def spawn(module: str, *args) -> subprocess.Popen:
    """``python -m module args...`` with piped stdin and stdout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return subprocess.Popen([sys.executable, "-m", module, *map(str, args)],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env,
                            close_fds=True)


def end_process(proc: subprocess.Popen):
    """Close the child's stdin, wait for it, kill it if it lingers."""
    try:
        proc.stdin.close()
    except OSError:
        pass
    try:
        proc.wait(timeout=5)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
