"""The offline render's per-render set-up a block: the program's
``render.compile`` (each ``compile_patch``) and ``render.prepare``
(``prepare_aux`` and ``init_state``) spans of ``engine/render.py``, ms a
block."""

from portbench.program_spans import ms_per_unit

LAYER, UNIT, BETTER, SOURCE, MOVES = ("offline block loop", "ms/block", "lower", "program_span",
                                      "render_x_realtime")


def read(rec):
    return ms_per_unit(rec, "render.compile", "render.prepare")
