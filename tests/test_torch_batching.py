"""The port's ``DynamicBatcher`` (threads and ``concurrent.futures`` in
place of the JAX batcher's asyncio) with a fake pipeline: the two contracts
of tests/test_batching.py (cancelled load is shed; ``close()`` fails what
is pending and rejects what is new), plus its batching window and cap. The
HTTP suite (tests/test_torch_server.py) covers the integrated path."""

import threading
import time

import pytest

from rwkv_tts_tpu_torch.config import BatchConfig, TtsArgs
from rwkv_tts_tpu_torch.runtime.batching import (DynamicBatcher,
                                                 InferenceTimeout)


class FakePipeline:
    """Records which requests actually reach the device thread."""

    def __init__(self, delay_s=0.0):
        self.calls = []
        self.delay_s = delay_s

    def synthesize_batch(self, args):
        self.calls.append([a.text for a in args])
        time.sleep(self.delay_s)

        class R:  # minimal result stand-in
            rtf = 0.01
            audio = b""
        return [R() for _ in args]


def in_thread(fn):
    """Run ``fn`` on a thread; returns (thread, box) where box gets
    ("ok", value) or ("err", exception)."""
    box = []

    def run():
        try:
            box.append(("ok", fn()))
        except Exception as e:  # noqa: BLE001: handed to the test
            box.append(("err", e))

    t = threading.Thread(target=run)
    t.start()
    return t, box


def test_cancelled_requests_are_shed():
    """A request whose caller gave up (inference timeout) must not occupy
    a device batch: under backlog the device would keep synthesizing audio
    nobody will receive."""
    pipe = FakePipeline(delay_s=0.3)
    b = DynamicBatcher(pipe, BatchConfig(max_batch_size=4,
                                         collect_timeout_ms=50,
                                         inference_timeout_ms=150))
    try:
        # the first request holds the device thread for 300 ms; the second
        # times out (150 ms) while still queued, so by the time the
        # collector packs the next batch its future is cancelled
        t1, box1 = in_thread(lambda: b.submit(TtsArgs(text="long")))
        time.sleep(0.08)            # let batch 1 dispatch
        with pytest.raises(InferenceTimeout):
            b.submit(TtsArgs(text="doomed"))
        t1.join(timeout=10)
        assert not t1.is_alive()
        assert box1[0][0] == "err" and \
            isinstance(box1[0][1], InferenceTimeout)   # also past its deadline
        time.sleep(0.5)             # give the collector time to (not) run it
        flat = [t for batch in pipe.calls for t in batch]
        assert "doomed" not in flat, pipe.calls
        assert b.stats["timeouts"] == 2
    finally:
        b.close()


def test_close_fails_pending_and_rejects_new():
    pipe = FakePipeline()
    b = DynamicBatcher(pipe, BatchConfig(max_batch_size=4,
                                         collect_timeout_ms=5,
                                         inference_timeout_ms=60000))
    r = b.submit(TtsArgs(text="ok"))
    assert r.rtf > 0
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(TtsArgs(text="after close"))


def test_close_fails_what_is_still_queued():
    """Requests queued behind a running batch fail with "batcher closed"
    when the batcher closes; the running batch hands out its results."""
    pipe = FakePipeline(delay_s=0.4)
    b = DynamicBatcher(pipe, BatchConfig(max_batch_size=1,
                                         collect_timeout_ms=1,
                                         inference_timeout_ms=60000))
    t1, box1 = in_thread(lambda: b.submit(TtsArgs(text="running")))
    time.sleep(0.1)
    t2, box2 = in_thread(lambda: b.submit(TtsArgs(text="queued")))
    time.sleep(0.1)
    b.close()
    for t in (t1, t2):
        t.join(timeout=10)
        assert not t.is_alive()
    assert box1[0][0] == "ok"
    assert box2[0][0] == "err" and "closed" in str(box2[0][1])
    assert pipe.calls == [["running"]]


def test_window_groups_requests_up_to_the_cap():
    """Requests arriving within the collect window share one batch, at most
    ``max_batch_size`` of them."""
    pipe = FakePipeline()
    b = DynamicBatcher(pipe, BatchConfig(max_batch_size=3,
                                         collect_timeout_ms=300,
                                         inference_timeout_ms=60000))
    try:
        runs = [in_thread(lambda i=i: b.submit(TtsArgs(text=f"r{i}")))
                for i in range(5)]
        for t, box in runs:
            t.join(timeout=10)
            assert not t.is_alive() and box[0][0] == "ok"
        assert sorted(len(c) for c in pipe.calls) == [2, 3]
        assert b.stats == {"requests": 5, "batches": 2,
                           "batched_requests": 5, "timeouts": 0}
    finally:
        b.close()
