"""The port's profiling tool (``mixlab_tpu_torch.tools.profile_env_eq``) on
the CPU: the passthrough twin against numpy (bit for bit), every row built
and run at a small block, and the tool's ``EqDummy`` kind registered only
while the rows run."""

import numpy as np
import pytest
import torch

from mixlab_tpu import protocol as jp
from mixlab_tpu_torch import protocol as p
from mixlab_tpu_torch.dsp import registry
from mixlab_tpu_torch.tools import profile_env_eq as tool

CPU = torch.device("cpu")
SMALL_TICKS = 16  # 12,800 samples at 48 kHz: whole 128-sample chunks, region-sized
PROGRAMS = {"env": "module", "eq": "module", "chain": "region", "full": "region",
            "full_noosc": "region", "full_dummy_eq": "regular", "no_env": "region",
            "no_eq": "regular", "no_both": "regular"}


def test_passthrough_twin_equals_numpy():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 10.0 ** rng.integers(
        -30, 30, 4096), np.array([0.0, -0.0, 1.0, -1.0, 3.4e38, 1e-45, np.inf, -np.inf],
                                 np.float32)]).astype(np.float32)
    n = tool.passthrough_cuda.launches
    for fn in (tool.passthrough_torch, tool.passthrough_cuda):  # the wrapper takes the twin here
        got = fn(torch.from_numpy(x)).numpy()
        want = x * np.float32(1.0000001)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert tool.passthrough_cuda.launches == n
    assert tool.GAIN == np.float32(1.0000001) and float(tool.GAIN) == 1.0 + 2.0 ** -23


@pytest.mark.parametrize("name", tool.ROWS)
def test_every_row_builds_and_runs(name):
    """Two blocks of each row on the CPU: a finite checksum, the block
    count, the program the row took."""
    with registry.registered(tool.EqDummyDef()):
        row = tool.build_rows(CPU, SMALL_TICKS, [name])[name]
        total = row.make(2)()
    assert np.isfinite(total) and row.blocks == 2
    assert row.program == PROGRAMS[name]
    if name not in ("no_both",):
        assert total != 0.0


def test_dummy_eq_row_runs_the_passthrough_in_the_eq_place():
    """The dummy row's graph is the no-eq graph with the passthrough
    between splitter and panner: its checksum differs from no_eq's only by
    the gain on one channel."""
    with registry.registered(tool.EqDummyDef()):
        rows = tool.build_rows(CPU, SMALL_TICKS, ["full_dummy_eq", "no_eq"])
        dummy, plain = (rows[k].make(1)() for k in ("full_dummy_eq", "no_eq"))
    assert dummy != plain and abs(dummy - plain) <= 1e-5 * abs(plain)


def test_tool_registers_its_kind_only_while_it_runs():
    jax_kinds = set(jp.ModuleParams.KINDS)
    assert set(registry.all_kinds()) == jax_kinds == set(p.ModuleParams.KINDS)
    seen = []

    def log(line):
        seen.append(("EqDummy" in registry.all_kinds(), "EqDummy" in p.ModuleParams.KINDS))

    res = tool.profile_rows("cpu", reps=1, n1=1, n2=2, block_ticks=SMALL_TICKS,
                            names=("env", "full_dummy_eq"), log=log)
    assert seen == [(True, True)]
    assert set(registry.all_kinds()) == jax_kinds == set(p.ModuleParams.KINDS)
    assert [r["name"] for r in res] == ["env", "full_dummy_eq"]
    for r in res:
        # one warm-up of each slope point, then two timed runs of each
        assert r["blocks"] == 3 * (1 + 2) and r["us_per_s"] > 0
        assert r["launches"] == dict.fromkeys(("envelope", "eq_cascade", "region",
                                               "passthrough"), 0)  # the CPU runs the twins
    with pytest.raises(ValueError, match="unknown module kind"):
        p.ModuleParams("EqDummy", None)


def test_registered_refuses_known_kinds_and_cleans_up_after_errors():
    with pytest.raises(ValueError, match="already registered"):
        with registry.registered(registry.get_def("EqThree")):
            pass
    with pytest.raises(RuntimeError, match="boom"):
        with registry.registered(tool.EqDummyDef()):
            assert registry.get_def("EqDummy").kind == "EqDummy"
            raise RuntimeError("boom")
    assert "EqDummy" not in registry.all_kinds() and "EqDummy" not in p.ModuleParams.KINDS
    with pytest.raises(KeyError):
        registry.get_def("EqDummy")


def test_timed_slope_differences_out_fixed_cost():
    calls = []

    def make(n):
        def run():
            calls.append(n)
            return float(n)
        return run

    s = tool.timed_slope(make, 1, 3, reps=2)
    assert s > 0 and calls == [1, 3, 1, 1, 3, 3]
