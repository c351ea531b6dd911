"""Dynamic request batching for the static engine, on threads.

Port of ``rwkv_tts_tpu/runtime/batching.py`` (the analog of the
reference's ``DynamicBatchManager``, src/dynamic_batch_manager.rs). The
JAX batcher runs on the server's asyncio loop; the port's server serves
each connection on a thread of its own, so here a caller's thread blocks
in ``submit`` on a ``concurrent.futures.Future`` and one collector thread
owns the device work:

  * requests land in a bounded queue (``max_queue``);
  * the collector drains it for a short window (``collect_timeout_ms``,
    :194-247 of the reference) into groups of at most ``max_batch_size``
    and runs each group as one ``TtsPipeline.synthesize_batch`` (which
    splits a mixed group by mode);
  * ``inference_timeout_ms`` is enforced: a caller that gives up cancels
    its future, and a cancelled request is shed before it reaches the
    engine;
  * ``close()`` fails what is pending and rejects what is new.
"""

from __future__ import annotations

import concurrent.futures
import logging
import queue
import threading
import time
from typing import List, Optional, Tuple

from ..config import BatchConfig, TtsArgs

log = logging.getLogger(__name__)

_STOP = object()     # wakes the collector on close()


class InferenceTimeout(TimeoutError):
    pass


class DynamicBatcher:
    def __init__(self, pipeline, cfg: BatchConfig = BatchConfig()):
        """``pipeline``: anything with ``synthesize_batch(list of TtsArgs)
        -> list of results`` (``TtsPipeline``)."""
        self.pipeline = pipeline
        self.cfg = cfg
        self._queue: "queue.Queue" = queue.Queue(maxsize=cfg.max_queue)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0,
                      "timeouts": 0}

    def start(self):
        with self._lock:
            if self._thread is None and not self._closed:
                self._thread = threading.Thread(
                    target=self._collector, daemon=True,
                    name="batcher-collector")
                self._thread.start()

    def close(self):
        """Stop the collector and fail everything still queued. A batch
        already running on the device finishes and hands out its results
        first (the collector is joined)."""
        with self._lock:
            self._closed = True
            t = self._thread
        if t is not None:
            self._queue.put(_STOP)
            t.join()
        self._fail_queued(RuntimeError("batcher closed"))

    def submit(self, args: TtsArgs):
        """Enqueue one request and block until its batch completes; raises
        ``InferenceTimeout`` past ``inference_timeout_ms``."""
        if self._closed:
            raise RuntimeError("batcher closed")
        self.start()
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._lock:
            self.stats["requests"] += 1
        timeout = self.cfg.inference_timeout_ms / 1000.0
        deadline = time.monotonic() + timeout
        try:
            self._queue.put((args, fut), timeout=timeout)
            if self._closed:
                # close() may have drained the queue before this put
                self._fail_queued(RuntimeError("batcher closed"))
            return fut.result(timeout=max(0.0, deadline - time.monotonic()))
        except (queue.Full, concurrent.futures.TimeoutError):
            # a settled future is shed by the collector: the device never
            # synthesizes audio nobody will receive
            fut.cancel()
            with self._lock:
                self.stats["timeouts"] += 1
            raise InferenceTimeout(
                f"inference exceeded {self.cfg.inference_timeout_ms:.0f} ms"
            ) from None

    # ------------------------------------------------------------------

    def _fail_queued(self, err: Exception):
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not _STOP:
                settle_future(item[1], exc=err)

    def _collector(self):
        closed = RuntimeError("batcher closed")
        stop = False
        while not stop:
            item = self._queue.get()
            if item is _STOP:
                return
            batch: List[Tuple[TtsArgs, concurrent.futures.Future]] = [item]
            deadline = time.monotonic() + self.cfg.collect_timeout_ms / 1000.0
            while len(batch) < self.cfg.max_batch_size and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                batch.append(nxt)
            if self._closed:
                # close() fails what is pending; only a batch already on
                # the device finishes
                for _, f in batch:
                    settle_future(f, exc=closed)
                continue            # drain the queue up to _STOP
            # shed dead load: a request whose caller gave up (its future
            # is cancelled) must not occupy a device batch
            batch = [(a, f) for a, f in batch
                     if f.set_running_or_notify_cancel()]
            if batch:
                self._run_batch(batch)

    def _run_batch(self, batch):
        with self._lock:
            self.stats["batches"] += 1
            self.stats["batched_requests"] += len(batch)
        try:
            results = self.pipeline.synthesize_batch([a for a, _ in batch])
        except Exception as e:  # noqa: BLE001: fail every request of it
            log.exception("batch failed")
            for _, f in batch:
                settle_future(f, exc=e)
            return
        for (_, f), r in zip(batch, results):
            settle_future(f, result=r)


def settle_future(fut: concurrent.futures.Future, result=None, exc=None
                  ) -> None:
    """Resolve ``fut`` unless it is already settled (a caller that gave
    up cancelled it)."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except concurrent.futures.InvalidStateError:
        pass
