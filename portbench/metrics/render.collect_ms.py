"""The offline render's collect a block: the program's ``render.collect``
span (``engine/render.py``: each block's taps to host memory, where the
host waits for the card), ms a block."""

from portbench.program_spans import ms_per_unit

LAYER, UNIT, BETTER, SOURCE, MOVES = ("offline block loop", "ms/block", "lower", "program_span",
                                      "render_x_realtime")


def read(rec):
    return ms_per_unit(rec, "render.collect")
