"""A failed CUDA-graph capture in ``train/capture.py`` leaves its step able
to capture again, and a thread makes its library handles before it
captures.

The real ``torch.cuda.graph`` raises from ``capture_end`` when the capture
was broken, before the caching allocator stops recording into the graph's
memory pool; the next capture into that pool then reads "beginAllocateToPool:
already recording", so one failure used to cascade into every later
capture of the step.  These tests stand in a fake graph context and a fake
allocator that keep those rules (the host has no card), and check that a
broken capture raises ``CaptureError`` (no eager fallback), closes its
pool's recording and the generators' capture, restores the caller's
stream, and that the next capture of the same signature succeeds.  The card's check is ``chip_smoke.py``
phase 31 (b): captured replicas beside a training thread.
"""

import threading

import pytest
import torch

from deeplearning4j_tpu_torch.train import capture
from deeplearning4j_tpu_torch.train.capture import CapturedStep, CaptureError


class _Allocator:
    """The caching allocator's pool bookkeeping, as far as a capture sees it."""

    def __init__(self):
        self.recording = set()
        self.pools = 0

    def handle(self):
        self.pools += 1
        return (0, self.pools)

    def end(self, device, pool):
        if pool not in self.recording:
            raise RuntimeError("endAllocatePool: not currently recording to mempool_id")
        self.recording.discard(pool)


class _Graph:
    def __init__(self):
        self.generators = []

    def register_generator_state(self, gen):
        self.generators.append(gen)


@pytest.fixture
def fake_cuda(monkeypatch):
    alloc = _Allocator()
    streams = {"current": "default", "set": [], "events": []}

    class graph_ctx:
        def __init__(self, graph, pool=None, capture_error_mode="global"):
            assert capture_error_mode == "thread_local"
            self.pool = pool

        def __enter__(self):
            streams["events"].append("capture")
            if self.pool in alloc.recording:
                raise RuntimeError("beginAllocateToPool: already recording to mempool_id")
            alloc.recording.add(self.pool)
            streams["current"] = "capture"

        def __exit__(self, exc_type, *rest):
            if exc_type is not None:
                # capture_end raises first: neither the pool's recording nor
                # the stream context is closed
                raise RuntimeError("CUDA error: operation failed due to a previous error "
                                   "during capture")
            alloc.recording.discard(self.pool)
            streams["current"] = "default"

    def set_stream(s):
        streams["set"].append(s)
        streams["current"] = s

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", alloc.handle)
    monkeypatch.setattr(torch.cuda, "graph", graph_ctx)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: streams["current"])
    monkeypatch.setattr(torch.cuda, "set_stream", set_stream)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_endAllocateToPool", alloc.end)

    def ready(device):
        # whether the capture lock is held here: another thread cannot take it
        taken = []
        other = threading.Thread(target=lambda: taken.append(
            capture._capture_lock.acquire(blocking=False)))
        other.start()
        other.join()
        if taken[0]:
            capture._capture_lock.release()
        streams["events"].append(("ready", device, "locked" if not taken[0] else "unlocked"))

    monkeypatch.setattr(capture, "_ready_thread", ready)
    monkeypatch.setattr(capture, "_end_generator_capture",
                        lambda gens: streams["events"].append(("end_generators", gens)))
    return alloc, streams


def _step(fail_first: int):
    calls = {"n": 0}

    def fn(tree, x):
        calls["n"] += 1
        if calls["n"] <= fail_first:
            raise RuntimeError("CUDA error: operation not permitted when stream is capturing")
        return (tree["w"] * x).sum()

    return CapturedStep(fn, n_trees=1, name="recovery"), calls


def test_a_failed_capture_raises_closes_its_pool_and_the_next_captures(fake_cuda):
    alloc, streams = fake_cuda
    step, calls = _step(fail_first=1)
    args = ({"w": torch.ones(3)}, torch.arange(3.0))
    sig = capture._batch_signature(args[1:])
    with pytest.raises(CaptureError, match="recovery.*failed") as info:
        step._capture(args, sig)
    assert "not permitted when stream is capturing" in repr(info.value.__cause__.__context__)
    assert alloc.recording == set()                  # the pool's recording closed
    assert streams["current"] == "default" and streams["set"] == ["default"]
    assert streams["events"][-1] == ("end_generators", ())   # and the generators' capture
    g = step._capture(args, sig)                     # no "already recording"
    assert calls["n"] == 2 and alloc.pools == 2 and alloc.recording == set()
    assert float(g.outputs[0]) == 3.0


def test_repeated_failures_each_raise_their_own_error(fake_cuda):
    alloc, _ = fake_cuda
    step, calls = _step(fail_first=3)
    args = ({"w": torch.ones(2)}, torch.ones(2))
    sig = capture._batch_signature(args[1:])
    for _ in range(3):
        with pytest.raises(CaptureError) as info:
            step._capture(args, sig)
        assert "already recording" not in str(info.value)
    step._capture(args, sig)
    assert calls["n"] == 4 and alloc.recording == set()


def test_a_pool_whose_capture_ended_itself_is_left_alone(fake_cuda):
    alloc, _ = fake_cuda
    step, _ = _step(fail_first=0)
    args = ({"w": torch.ones(2)}, torch.ones(2))
    step._capture(args, capture._batch_signature(args[1:]))
    pool = step._pool
    step._close_pool()                               # not recording: nothing to end
    assert step._pool is None and pool not in alloc.recording


def test_the_capturing_thread_makes_its_library_handles_first(fake_cuda):
    # a worker thread may reach its first capture before it ever ran a step;
    # making a cuBLAS or cuDNN handle inside the capture is refused, and so
    # is making one while another thread captures: it happens under the lock
    _, streams = fake_cuda
    step, _ = _step(fail_first=0)
    args = ({"w": torch.ones(2)}, torch.ones(2))
    step._capture(args, capture._batch_signature(args[1:]))
    step._capture(args, capture._batch_signature(args[1:]))
    assert streams["events"] == [("ready", 0, "locked"), "capture", ("ready", 0, "locked"),
                                 "capture"]

