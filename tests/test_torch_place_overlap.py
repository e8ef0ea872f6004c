"""The job path's overlapped placement (``IteratedConv2D._place_and_run``).

A pinned CPU tensor bound for a card is copied ``non_blocking`` on the
current stream, an event is recorded behind the copy, every launch of the
call queues behind it, and the event is waited for before ``forward`` or
``batch`` returns (or raises), so the caller may rewrite its buffer at
once. Every other input takes the blocking copy. The card's copy, stream,
event and launch calls are stubbed: the copy hands back a ``meta`` tensor,
which K1's wrapper takes down its card path to a fake library, so the
calls are logged in the order the model issues them.
"""

import contextlib
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_stencil_torch import obs
from tpu_stencil_torch.models import blur
from tpu_stencil_torch.models.blur import IteratedConv2D
from tpu_stencil_torch.obs import tracing
from tpu_stencil_torch.ops import cuda_stencil as cs

torch.set_num_threads(1)

CUDA = torch.device("cuda")
SHAPE = (64, 48, 3)
REPS = 100
LAUNCHES = 16  # 12 fused launches of 8 reps and 4 single-rep tails


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset()
    yield
    obs.reset()


class _Card:
    """The card's calls, stubbed: ``log`` holds (what, detail, ns) in the
    order the model made them; ``pinned`` the tensors that read as
    page-locked."""

    def __init__(self, monkeypatch, fail_at=None):
        self.log = []
        self.pinned = []
        card = self
        real_to = torch.Tensor.to

        def to(t, *args, **kw):
            dev = kw.get("device", args[0] if args else None)
            if isinstance(dev, (str, torch.device)) and (
                    torch.device(dev).type == "cuda"):
                card.note("copy", bool(kw.get("non_blocking", False)))
                return torch.empty(t.shape, dtype=kw.get("dtype", t.dtype),
                                   device="meta")
            return real_to(t, *args, **kw)

        class Event:
            def synchronize(self):
                card.note("wait")

        class Stream:
            cuda_stream = 0

            def record_event(self):
                card.note("record")
                return Event()

        class Lib:
            def stencil_fused_launch(self, *args):
                card.note("launch")
                if fail_at is not None and card.count("launch") == fail_at:
                    raise RuntimeError("launch refused")
                return 0

        monkeypatch.setattr(torch.Tensor, "to", to)
        monkeypatch.setattr(torch.Tensor, "is_pinned",
                            lambda t: any(t is p for p in card.pinned))
        monkeypatch.setattr(torch.Tensor, "data_ptr", lambda t: id(t))
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda d=None: Stream())
        monkeypatch.setattr(torch.cuda, "device",
                            lambda d: contextlib.nullcontext())
        monkeypatch.setattr(cs, "_fused_lib", lambda: Lib())
        monkeypatch.setattr(cs, "_check_cuda", lambda *ts: None)

    def note(self, what, detail=None):
        self.log.append((what, detail, time.time_ns()))

    def count(self, what):
        return sum(w == what for w, _, _ in self.log)

    def calls(self):
        return [(w, d) for w, d, _ in self.log]

    def stamp(self, what):
        return next(ns for w, _, ns in self.log if w == what)


def _img(shape=SHAPE, seed=3):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _model(device=CUDA):
    return IteratedConv2D("gaussian", backend="pallas", device=device)


def _pinned(card, arr):
    t = torch.from_numpy(arr)
    card.pinned.append(t)
    return t


def _overlapped_calls(launches=LAUNCHES):
    return ([("copy", True), ("record", None)] + [("launch", None)] * launches
            + [("wait", None)])


@pytest.mark.parametrize("call", ["forward", "batch"])
def test_a_pinned_input_is_copied_non_blocking_and_waited_for_last(
        monkeypatch, call):
    card = _Card(monkeypatch)
    model = _model()
    before = blur.placement_counts()
    if call == "forward":
        x = _pinned(card, _img())
        y = model(x, REPS)
    else:
        x = _pinned(card, np.stack([_img(seed=3), _img(seed=4)]))
        y = model.batch(x, REPS)
    # the copy first, its event right behind it, every launch of the call
    # queued behind that, and the copy's wait last of all, before return
    assert card.calls() == _overlapped_calls()
    assert y.shape == x.shape and y.device.type == "meta"
    assert blur._delta(before, blur.placement_counts()) == {"overlapped": 1}


def test_the_copy_is_waited_for_when_a_launch_raises(monkeypatch):
    card = _Card(monkeypatch, fail_at=3)
    model = _model()
    x = _pinned(card, _img())
    with pytest.raises(RuntimeError, match="launch refused"):
        model(x, REPS)
    # the caller may rewrite its buffer once the error reaches it
    assert card.calls() == _overlapped_calls(launches=3)


@pytest.mark.parametrize("kind", ["numpy", "pageable", "on_device",
                                  "cpu_model"])
def test_every_other_input_takes_the_blocking_copy(monkeypatch, kind):
    card = _Card(monkeypatch)
    img = _img()
    model = _model(torch.device("cpu") if kind == "cpu_model" else CUDA)
    x = {"numpy": lambda: img,
         "pageable": lambda: torch.from_numpy(img),
         "on_device": lambda: torch.empty(SHAPE, dtype=torch.uint8,
                                          device="meta"),
         "cpu_model": lambda: _pinned(card, img)}[kind]()
    before = blur.placement_counts()
    y = model(x, REPS)
    assert blur._delta(before, blur.placement_counts()) == {"blocking": 1}
    assert card.count("record") == card.count("wait") == 0
    assert ("copy", True) not in card.calls()
    if kind == "cpu_model":
        assert card.calls() == []
        np.testing.assert_array_equal(
            y.numpy(), _model(torch.device("cpu"))(img, REPS).numpy())
    else:
        # the placement blocks, and precedes every launch
        assert card.calls() == [("copy", False)] + [
            ("launch", None)] * LAUNCHES


def test_a_pageable_batch_takes_the_blocking_copy(monkeypatch):
    card = _Card(monkeypatch)
    before = blur.placement_counts()
    _model().batch(torch.from_numpy(np.stack([_img(), _img(seed=4)])), REPS)
    assert card.calls() == [("copy", False)] + [("launch", None)] * LAUNCHES
    assert blur._delta(before, blur.placement_counts()) == {"blocking": 1}


def _model_spans():
    return [r for r in tracing.profiled_spans(0, 1 << 62)
            if r.name.startswith("model.")]


@pytest.mark.parametrize("call", ["forward", "batch"])
def test_overlapped_place_span_holds_the_copy_the_issue_and_the_wait(
        monkeypatch, call):
    card = _Card(monkeypatch)
    model = _model()
    arr = _img() if call == "forward" else np.stack([_img(), _img(seed=4)])
    x = _pinned(card, arr)
    with profile(activities=[ProfilerActivity.CPU]):
        (model if call == "forward" else model.batch)(x, REPS)
    place, issue = _model_spans()
    assert (place.name, issue.name) == ("model.place", "model.issue")
    assert place.args == {"bytes": arr.nbytes, "overlapped": True}
    # model.place opens before the copy is issued and closes after the
    # wait; model.issue, with every launch, nests inside it
    assert place.start_ns <= card.stamp("copy")
    assert card.stamp("wait") <= place.end_ns
    assert place.start_ns <= issue.start_ns <= issue.end_ns <= place.end_ns
    assert issue.depth == place.depth + 1
    assert issue.end_ns <= card.stamp("wait")
    assert issue.args["launches"] == LAUNCHES
    assert issue.args["bodies"] == {"regs": 12, "swar": 4}


def test_blocking_place_span_closes_before_the_issue(monkeypatch):
    card = _Card(monkeypatch)
    img = _img()
    with profile(activities=[ProfilerActivity.CPU]):
        _model()(torch.from_numpy(img), REPS)
    place, issue = _model_spans()
    assert place.args == {"bytes": img.nbytes}
    assert place.start_ns <= card.stamp("copy") <= place.end_ns
    assert place.end_ns <= issue.start_ns and issue.depth == place.depth
    assert issue.args["launches"] == LAUNCHES


def test_placement_counts_move_by_one_a_call(monkeypatch):
    card = _Card(monkeypatch)
    model = _model()
    x = _pinned(card, _img())
    before = blur.placement_counts()
    for _ in range(3):
        model(x, 2)
    model(_img(), 2)
    model(torch.from_numpy(_img()), 2)
    assert blur._delta(before, blur.placement_counts()) == {
        "overlapped": 3, "blocking": 2}
    counts = blur.placement_counts()
    counts["overlapped"] += 100  # a copy: the process's counters stay
    assert blur.placement_counts()["overlapped"] == before["overlapped"] + 3
