"""The port's shared launch path (``mixlab_tpu_torch/kernels.py``) on the
CPU: the wrappers' checks build their message only when they fail, and a
CUDA-only path refuses everything else before it reaches a kernel."""

import pytest
import torch

from mixlab_tpu_torch import kernels
from mixlab_tpu_torch.video import blend, resize_cuda


class CountingInt(int):
    """An int argument that counts how often it is turned into text."""

    def __init__(self, value):
        self.calls = 0

    def __str__(self):
        self.calls += 1
        return int.__repr__(self)

    __repr__ = __str__


def _crossfade(value):
    plane = torch.zeros((2, 4), dtype=torch.uint8)
    blend.crossfade_cuda([plane], [plane], value)


def _resize(value):
    plane = torch.zeros((4, 6), dtype=torch.uint8, device="meta")
    resize_cuda.resize_picture_polyphase([plane], [(4, value)])


# a wrapper's check that formats the int argument into its message: the value
# that passes it, then the device check that follows; the value that fails it
CHECKS = {
    "crossfade fade": (_crossfade, 128, r"^crossfade: unsupported device cpu$", 300,
                       "crossfade: fade must be an int in 0..255, got 300"),
    "resize plan": (_resize, 9, r"^resize: unsupported device meta$", 100,
                    "resize: no polyphase plan for 6 -> 100 (at most 16 phases and 12 taps)"),
}


@pytest.mark.parametrize("check", list(CHECKS))
def test_passing_check_formats_nothing(check):
    call, good, then, _, _ = CHECKS[check]
    value = CountingInt(good)
    with pytest.raises(ValueError, match=then):
        call(value)
    assert value.calls == 0


@pytest.mark.parametrize("check", list(CHECKS))
def test_failing_check_raises_its_full_message(check):
    call, _, _, bad, message = CHECKS[check]
    value = CountingInt(bad)
    with pytest.raises(ValueError) as err:
        call(value)
    assert str(err.value) == message
    assert value.calls == 1


@pytest.mark.parametrize("t", [torch.zeros(3), torch.zeros(3, device="meta"), [0.0], None],
                         ids=["cpu", "meta", "list", "none"])
def test_cuda_index_refuses_all_but_cuda_tensors(t):
    with pytest.raises(ValueError, match=r"^wrapper: unsupported device "):
        kernels.cuda_index(t, "wrapper")


class FakeLibrary:
    """Stands in for the built library: records calls, returns ``rc``."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def mixlab_passthrough(self, *args):
        self.calls.append(args)
        return self.rc

    def mixlab_cuda_error_string(self, rc):
        return b"an error"


@pytest.fixture
def fake_card(monkeypatch):
    """The launch path's CUDA binding on a CPU build: a raw stream handle
    per card."""
    state = {"loads": 0}
    lib = FakeLibrary()

    def load():
        state["loads"] += 1
        return lib

    monkeypatch.setattr(kernels, "load", load)
    monkeypatch.setattr(kernels, "_entries", {})
    monkeypatch.setattr(kernels, "_raw_stream", None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 5000 + i,
                        raising=False)
    return state, lib


def test_launch_keeps_the_entry_point_and_names_the_card(fake_card):
    """The entry point is looked up once; every call ends with the card's
    index and that card's current stream (the C side switches cards)."""
    state, lib = fake_card
    kernels.launch("mixlab_passthrough", "passthrough kernel launch", 0, 11, 12, 384_000)
    kernels.launch("mixlab_passthrough", "passthrough kernel launch", 1, 13, 14, 1)
    assert lib.calls == [(11, 12, 384_000, 0, 5000), (13, 14, 1, 1, 5001)]
    assert state["loads"] == 1
    lib.rc = 700
    with pytest.raises(RuntimeError, match=r"^passthrough kernel launch: CUDA error 700 "):
        kernels.launch("mixlab_passthrough", "passthrough kernel launch", 0, 1, 2, 3)


def test_every_entry_point_ends_with_the_card_and_the_stream():
    c_int, c_ptr = kernels.ctypes.c_int, kernels.ctypes.c_void_p
    for name, argtypes in kernels._SIGNATURES.items():
        assert argtypes[-2:] == [c_int, c_ptr], name
    text = "".join(src.read_text() for src in kernels.sources())
    for name in kernels._SIGNATURES:
        head = text[text.index(f"int {name}("):]
        head = head[:head.index("{")]
        assert head.rstrip().endswith("int device, void* stream_ptr)") or \
            head.rstrip().endswith("int device, void* stream)"), name
