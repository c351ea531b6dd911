"""CUDA graphs of the port's device programs: the card's counterpart of the
JAX package's jitted programs.

The JAX package runs each engine's decode as one compiled device program
(``rwkv_tts_tpu/runtime/engine.py`` ``global_stage`` / ``semantic_stage``,
``rwkv_tts_tpu/runtime/continuous.py`` ``decode_block``), and likewise the
prefill (``rwkv7.forward`` under ``jax.jit``, per prompt-length bucket), the
vocoder (``bicodec.decode``, ``@jax.jit``) and the parity engine's step.
Eager PyTorch enqueues the same work op by op from Python, thousands of
launches a step. A CUDA graph records a body's launches once and enqueues
all of them with one call, so the host stops pacing the card. The holders:
``engine.StageGraphs`` and ``engine.PrefillGraphs`` (the static engine),
``continuous.BlockGraphs`` (the continuous engine's blocks and, in the same
cache, its admission prefill), ``bicodec.DecodeGraphs`` (the vocoder's
windows and detokenize buckets) and ``parity.StepGraphs``.

``GraphCache`` holds one captured ``Program`` per shape key. A program's
body reads and writes only static buffers (tensors whose storage outlives
the program: the recurrent state, the logits, the slot tensors, the draw
tables, the emit buffer and a device-side step counter), so every replay
runs the body on what the buffers hold then. Capture follows torch's
recipe:

  * the body runs once first on a copy of its buffers, on the capture
    stream (the kernels' first-call set-up in their C entries, the
    libraries' handles and workspaces), so the buffers' values are not
    touched;
  * then it is captured on that stream with ``capture_error_mode =
    "thread_local"``: other threads (the streaming vocoders) keep
    launching while the decode thread captures;
  * one thread of the process warms up and captures at a time: torch
    synchronizes the device and empties its caches as a capture begins,
    which would invalidate a capture under way in another thread;
  * every program of a cache shares one memory pool
    (``torch.cuda.graph_pool_handle``): programs of one cache replay one
    at a time, so their intermediates may share memory. A cache that one
    thread drives replays on that thread's stream; a cache that several
    threads share (the static engine's prefill, the vocoder's windows) is
    entered through ``exclusive``, which also orders each caller's work
    after the previous caller's on the card.

A capture or replay that fails raises; nothing falls back to eager.

A body must never address a tensor that is reallocated between replays:
besides the pointers of its launches, the graph holds host-encoded TMA
descriptors (``csrc/sm90.cuh``, the conv1d and GEMM kernels) by value.
The buffers and the weights outlive their programs, and every
intermediate lives in the pool at the address the capture gave it.

Launch counts: a kernel wrapper called under capture records its kernel
into the graph instead of launching it, so ``ops/_build.record_launches``
notes it instead of counting it; each replay adds the capture's launches
to the counts (``ops/_build.add_launches``), so the ``LAUNCHES`` tables
count the kernels the card ran, eager or graphed.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import threading
import time
from typing import Any, Callable, Dict, Hashable, List, Tuple

import torch

from ..ops import _build
from ..utils import trace


_collector_lock = threading.Lock()
_collector = {"holds": 0, "was_on": False}

# One capture at a time in the process. Entering ``torch.cuda.graph``
# synchronizes the device and empties the allocator's and the pinned host
# memory's caches, and a warm-up may create a library's handle; done while
# another thread captures, either invalidates that capture (the serving
# threads capture their shapes at first use: the decode thread its blocks
# and admission prefills, the connections their vocoder windows)
_capture_lock = threading.Lock()


@contextlib.contextmanager
def collector_off():
    """Python's cyclic garbage collector held off while any thread captures.
    A collection that starts inside a capture, in the capturing thread, may
    free a dropped engine's graphs, and destroying a graph there is a call
    that invalidates the capture. Nested and concurrent holds count: the
    collector comes back, if it was on, when the last hold ends."""
    with _collector_lock:
        if _collector["holds"] == 0:
            _collector["was_on"] = gc.isenabled()
            gc.disable()
        _collector["holds"] += 1
    try:
        yield
    finally:
        with _collector_lock:
            _collector["holds"] -= 1
            if _collector["holds"] == 0 and _collector["was_on"]:
                gc.enable()


def clone_tree(tree):
    """A copy of every tensor in a (nested) dict, list or tuple."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree


class Program:
    """One captured body: its graph, the buffers it addresses (kept alive
    as long as the graph), the launches one replay makes, and what the
    capture took: ``capture_s`` (the body recorded, after the warm-up),
    ``instantiate_s`` (the graph ended and instantiated), ``warmup_s``,
    ``wait_s`` (waiting for another thread's capture to end) and
    ``pool_bytes`` (memory the pool reserved for it)."""

    def __init__(self, graph, buffers, launches, stats):
        self.graph = graph
        self.buffers = buffers
        self.launches: List[Tuple[Dict[str, int], str, int]] = launches
        self.stats = stats
        self.replays = 0

    def replay(self) -> None:
        """Enqueue the whole body on the current stream."""
        self.graph.replay()
        _build.add_launches(self.launches)
        self.replays += 1

    def kernel_launches(self) -> Dict[str, int]:
        """The counted kernels one replay launches, by name."""
        return {name: n for _, name, n in self.launches}


class GraphCache:
    """Captured programs by key, on one card, in one memory pool.

    ``program(key, body, buffers)`` returns the program of ``key``,
    capturing ``body(buffers)`` at its first use. The caller replays
    programs of one cache from one stream at a time."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a card, not {self.device}")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self.programs: Dict[Hashable, Program] = {}
        self._turn = threading.Lock()
        self._last_turn = None      # the event that ends the last turn
        self.turns = 0
        # host seconds spent waiting for a turn, from the stamps of the
        # recorder's ``turn.wait`` spans (``utils/trace``)
        self.wait_s = 0.0

    @contextlib.contextmanager
    def exclusive(self):
        """One caller's turn at the cache's programs and buffers, for a
        cache that several threads share: the host waits for the lock, the
        caller's stream waits (on the card, not the host) for the end of
        the previous turn's work, whatever stream that ran on, and the
        turn's end is recorded on the caller's stream. Inside a turn copy
        the inputs into the buffers, replay, and copy the outputs out on
        the device; read them back on the host after the turn, so that no
        caller holds another behind its read-back.

        While the recorder is on, the wait and the turn are its
        ``turn.wait`` and ``turn`` spans, under the request and parent span
        the caller's thread has bound (``trace.request``, ``trace.scope``)."""
        t0 = trace.now()
        with self._turn:
            t1 = trace.now()
            self.wait_s += (t1 - t0) * 1e-9
            self.turns += 1
            cur = torch.cuda.current_stream(self.device)
            if self._last_turn is not None:
                cur.wait_event(self._last_turn)
            try:
                yield
            finally:
                self._last_turn = torch.cuda.Event()
                self._last_turn.record(cur)
                if trace.on:
                    req, parent = trace.bound()
                    trace.span("turn.wait", t0, t1, req=req, cause=parent)
                    trace.span("turn", t1, trace.now(), req=req,
                               cause=parent)

    def __contains__(self, key) -> bool:
        return key in self.programs

    def program(self, key: Hashable, body: Callable[[Any], None],
                buffers) -> Program:
        prog = self.programs.get(key)
        if prog is None:
            prog = self.capture(body, buffers)
            self.programs[key] = prog
        return prog

    def capture(self, body: Callable[[Any], None], buffers) -> Program:
        """Warm ``body`` up on a copy of ``buffers``, then capture
        ``body(buffers)``; raises if either fails. Both run while no other
        thread of the process captures (``_capture_lock``); ``wait_s`` is
        the wait for that turn."""
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        t = time.perf_counter()
        with _capture_lock:
            t0 = time.perf_counter()
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                body(clone_tree(buffers))
            self.stream.synchronize()
            t1 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            with collector_off(), _build.record_launches() as noted:
                with torch.cuda.graph(graph, pool=self.pool,
                                      stream=self.stream,
                                      capture_error_mode="thread_local"):
                    reserved = torch.cuda.memory_reserved(dev)
                    body(buffers)
                    pool_bytes = torch.cuda.memory_reserved(dev) - reserved
                    t2 = time.perf_counter()
            t3 = time.perf_counter()
        # the replays run on the caller's stream, after what it enqueued
        cur.wait_stream(self.stream)
        counts = collections.Counter((id(t), n) for t, n in noted)
        tables = {id(t): t for t, _ in noted}
        launches = [(tables[i], n, c) for (i, n), c in counts.items()]
        return Program(graph, buffers, launches, {
            "wait_s": t0 - t, "warmup_s": t1 - t0, "capture_s": t2 - t1,
            "instantiate_s": t3 - t2, "pool_bytes": pool_bytes})

    def clear(self) -> None:
        """Drop every program (their graphs and pool memory)."""
        self.programs.clear()

    def stats(self) -> Dict[Hashable, dict]:
        return {k: dict(p.stats, replays=p.replays)
                for k, p in self.programs.items()}
