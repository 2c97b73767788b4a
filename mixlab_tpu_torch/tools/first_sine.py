"""How often the first multi-threaded CPU sine of a fresh process is wrong.

``python -m mixlab_tpu_torch.tools.first_sine [processes]`` starts that many
fresh Python processes, eight at a time.  Each takes the sine of a 60-tick
block of the 110 Hz oscillator's phase (44,100 samples at 44.1 kHz, enough
for PyTorch to split the call across its threads) twice, first through one
path, then through plain ``torch.sin``, and reports whether the two
results differ.  The paths are ``raw`` (``torch.sin``) and ``port``
(``dsp.audio._sin``, which first takes the sine of one element on the
calling thread).  Prints the count of processes whose first result differs,
for each path.
"""

from __future__ import annotations

import subprocess
import sys


def _child(path: str) -> None:
    import numpy as np
    import torch

    from mixlab_tpu_torch.dsp import audio

    sr, spt, freq = 44_100, 735, 110.0
    base = audio._frac(np.arange(60.0) * spt * (freq / sr)).astype(np.float32)
    i = torch.arange(spt, dtype=torch.float32)
    n = (torch.from_numpy(base)[:, None] + i[None, :] * np.float32(freq / sr)).reshape(-1)
    x = n * audio._TWO_PI
    first = audio._sin(x) if path == "port" else torch.sin(x)
    print("differs" if bool((first != torch.sin(x)).any()) else "same")


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if args[:1] == ["--child"]:
        _child(args[1])
        return
    n = int(args[0]) if args else 400
    for path in ("raw", "port"):
        cmd = [sys.executable, "-m", "mixlab_tpu_torch.tools.first_sine", "--child", path]
        out = []
        for start in range(0, n, 8):
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
                     for _ in range(min(8, n - start))]
            out += [p.communicate()[0].strip() for p in procs]
        print(f"{path}: the first sine differs in {out.count('differs')} of {len(out)} "
              f"fresh processes")


if __name__ == "__main__":
    main()
