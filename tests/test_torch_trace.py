"""The port's span recorder (``rwkv_tts_tpu_torch/utils/trace.py``) and
where the serving path writes to it, on the CPU at the goldens shape (2
layers × 128, the tiny BiCodec): off, nothing is recorded and the engine's
``stats`` and histograms read as before; on, one request's queue wait,
admission burst, blocks, readbacks and marks are filed under the id
``submit`` returned, the engine's ``stats`` and histograms are the spans'
own stamps (monotonic, so a stepped wall clock moves no duration), a
stream's windows and chunks carry the same id, and the exported stamps
are the wall clock's (``time.time_ns()``). On a card (``-m cuda``;
skipped here) the vocoder's turn is recorded under the caller's binding,
and a span around a graph replay encloses the replay's kernels in a
Kineto trace (the shared clock)."""

import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch.config import (BiCodecConfig, EngineConfig,
                                       RwkvConfig, TtsArgs)
from rwkv_tts_tpu_torch.models import bicodec
from rwkv_tts_tpu_torch.runtime.continuous import ContinuousEngine
from rwkv_tts_tpu_torch.runtime.engine import GenerationResult
from rwkv_tts_tpu_torch.runtime.pipeline import TtsPipeline
from rwkv_tts_tpu_torch.runtime.streaming import (StreamingVocoder,
                                                  stream_synthesize)
from rwkv_tts_tpu_torch.utils import bridge, trace


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


CFG = RwkvConfig(**chip_smoke.GOLDENS_CFG)
ECFG = EngineConfig(prefill_buckets=(32, 64), max_semantic_tokens=12,
                    batch_size=2)
BC_CFG = BiCodecConfig.tiny(feat_dim=64)
WAIT = 300.0
MS = 1_000_000


@pytest.fixture(scope="module")
def params():
    return bridge.rwkv7_params(chip_smoke.goldens_params(CFG, 1234), "cpu")


@pytest.fixture(scope="module")
def bc_params():
    return bicodec.init_params(BC_CFG, device="cpu")


@pytest.fixture()
def eng(params):
    """A fresh engine: its ``stats`` and histograms start at zero."""
    e = ContinuousEngine(params, CFG, ECFG, block=8, slots=2, device="cpu")
    yield e
    e.stop()


def submit(eng, args):
    """(trace id, result) of one request through ``submit``, the decode
    loop stopped after it (its last block in flight read back)."""
    box, done = [], threading.Event()
    tid = eng.submit(args, lambda r: (box.append(r), done.set()))
    assert done.wait(WAIT)
    eng.stop()
    return tid, box[0]


def by_name(spans, name, **match):
    return [s for s in spans
            if s.name == name and all(getattr(s, k) == v
                                      for k, v in match.items())]


# --------------------------------------------------------------------------
# the recorder
# --------------------------------------------------------------------------

def test_recorder_keeps_spans_and_marks_until_reset():
    trace.enable()
    off = trace._offset
    a = trace.span("a", 1, 2, req=3, cause=4, n=5, cpu=1)
    b = trace.span("b", 2, 3, sid=trace.new_id())
    trace.mark("m", 7, req=3, n=2)
    got = trace.export()
    # exported on the wall clock: each stamp moved by enable()'s offset
    assert got["spans"] == [trace.Span(a, "a", 1 + off, 2 + off, 3, 4, 5, 1),
                            trace.Span(b, "b", 2 + off, 3 + off, 0, 0, 0,
                                       -1)]
    assert a != b and a > 0 and b > 0
    assert got["marks"] == [trace.Mark("m", 7 + off, 3, 0, 2)]
    assert abs(time.time_ns() - (trace.now() + off)) < 5 * MS
    trace.reset()
    assert trace.export() == {"spans": [], "marks": []}


def test_threads_lose_no_span_or_mark():
    """Eight threads record at once with the interpreter switching
    threads every microsecond: every span and mark arrives."""
    trace.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for k in range(2000):
                trace.span("s", k, k + 1, req=i)
                trace.mark("m", k, req=i)
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = trace.export()
    assert len(got["spans"]) == len(got["marks"]) == 16000
    assert len({s.id for s in got["spans"]}) == 16000


def test_scope_binds_its_span_as_the_parent_in_its_thread_only():
    trace.enable()
    seen = {}
    with trace.request(7):
        with trace.scope("outer", n=3) as sid:
            trace.child("inner", trace.now(), n=1)
            th = threading.Thread(
                target=lambda: seen.update(other=trace.bound()))
            th.start()
            th.join()
            assert trace.bound() == (7, sid)
        assert trace.bound() == (7, 0)
    assert trace.bound() == (0, 0) and seen["other"] == (0, 0)
    spans = trace.export()["spans"]
    (outer,) = by_name(spans, "outer")
    (inner,) = by_name(spans, "inner")
    assert (outer.id, outer.req, outer.cause, outer.n) == (sid, 7, 0, 3)
    assert (inner.req, inner.cause, inner.n) == (7, sid, 1)
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1


def test_scope_ends_its_span_and_binding_when_its_block_raises():
    trace.enable()
    with pytest.raises(KeyError):
        with trace.scope("failed", 9):
            raise KeyError("x")
    assert trace.bound() == (0, 0)
    assert [s.req for s in by_name(trace.export()["spans"], "failed")] == [9]


# --------------------------------------------------------------------------
# the continuous engine
# --------------------------------------------------------------------------

def test_recorder_off_records_nothing_and_stats_read_as_before(eng):
    tid, res = submit(eng, TtsArgs(text="quiet run", seed=2, max_tokens=6))
    assert tid > 0 and res.trace_id == tid
    assert len(res.semantic_tokens) == 6 and len(res.global_tokens) == 32
    assert trace.export() == {"spans": [], "marks": []}
    st = eng.stats
    assert st["admitted"] == 1 and st["blocks"] >= 5
    for k in ("admit_s", "prefill_s", "copy_s", "dispatch_s", "process_s"):
        assert st[k] > 0.0, k
    assert eng.hist["queue_wait"].n == 1 and eng.hist["first_emit"].n == 1
    assert eng.hist["queue_wait"].total >= 0.0
    # a second request gets the next id
    tid2, res2 = submit(eng, TtsArgs(text="again", seed=3, max_tokens=2))
    assert tid2 > tid and res2.trace_id == tid2


def test_one_request_records_its_stages_in_order(eng):
    trace.enable()
    tid, res = submit(eng, TtsArgs(text="trace this", seed=5, max_tokens=6))
    got = trace.export()
    spans, marks = got["spans"], got["marks"]

    (q,) = by_name(spans, "queue", req=tid)
    (admit,) = by_name(spans, "admit")
    assert q.cause == admit.id and q.t1 == admit.t0 and q.t0 <= q.t1
    assert admit.n == 1 and 0 <= admit.cpu
    kids = [by_name(spans, n, cause=admit.id)
            for n in ("admit.prompt", "admit.prefill", "admit.scatter")]
    assert [len(k) for k in kids] == [1, 1, 1]
    prompt, prefill, scatter = (k[0] for k in kids)
    assert admit.t0 == prompt.t0 and prompt.t1 == prefill.t0
    assert prefill.t1 == scatter.t0 and scatter.t1 == admit.t1
    assert prefill.n == 1 and prompt.n == scatter.n == 1

    disp = by_name(spans, "dispatch")
    waits = by_name(spans, "readback.wait")
    routes = by_name(spans, "readback.route")
    assert disp and len(waits) == len(routes) == len(disp)
    assert disp[0].t0 >= admit.t1 and all(s.n == 2 for s in disp)
    assert [w.n for w in waits] == list(range(1, len(disp) + 1))
    for w, r in zip(waits, routes):
        assert w.t1 == r.t0
    assert sum(r.n for r in routes) == 32 + len(res.semantic_tokens)
    for s in disp + waits + routes:
        # the thread's CPU time fits inside the span's wall time
        assert 0 <= s.cpu <= s.t1 - s.t0 + MS, s

    names = [m.name for m in marks if m.req == tid]
    assert names == ["globals_done", "first_semantic"]
    g, f = (m for m in marks if m.req == tid)
    assert admit.t1 < g.t <= f.t <= routes[-1].t1
    assert len(res.semantic_tokens) == 6
    assert set(got) == {"spans", "marks"}


def test_stats_histograms_and_spans_share_their_stamps(eng):
    trace.enable()
    for i in range(3):
        submit(eng, TtsArgs(text=f"request {i}", seed=i, max_tokens=4))
    spans = trace.export()["spans"]

    def ns(*names):
        return sum(s.t1 - s.t0 for s in spans if s.name in names)

    def agree(seconds, nanos):
        assert abs(seconds * 1e9 - nanos) < 1.0, (seconds, nanos)

    st = eng.stats
    agree(st["admit_s"], ns("admit"))
    agree(st["prefill_s"], ns("admit.prefill"))
    agree(st["dispatch_s"], ns("dispatch"))
    agree(st["process_s"], ns("readback.wait", "readback.route"))
    agree(st["compact_s"], ns("compact"))
    assert st["blocks"] == len(by_name(spans, "dispatch"))
    agree(eng.hist["queue_wait"].total, ns("queue"))
    assert eng.hist["queue_wait"].n == len(by_name(spans, "queue")) == 3


def test_first_emit_histogram_reads_admission_to_first_semantic_mark(eng):
    trace.enable()
    tid, _ = submit(eng, TtsArgs(text="first emit", seed=8, max_tokens=3))
    got = trace.export()
    (q,) = by_name(got["spans"], "queue", req=tid)
    (f,) = [m for m in got["marks"] if m.name == "first_semantic"]
    h = eng.hist["first_emit"]
    assert h.n == 1 and abs(h.total * 1e9 - (f.t - q.t1)) < 1.0


def test_a_stepped_wall_clock_moves_no_duration(eng, monkeypatch):
    """The wall clock steps back an hour at every read while a request is
    served: the engine's durations and histograms stay the spans' own,
    and none is negative."""
    real, steps = time.time_ns, []

    def stepped():
        steps.append(1)
        return real() - 3600 * 10**9 * len(steps)

    trace.enable()
    monkeypatch.setattr(time, "time_ns", stepped)
    submit(eng, TtsArgs(text="stepped clock", seed=9, max_tokens=4))
    monkeypatch.setattr(time, "time_ns", real)
    spans = trace.export()["spans"]
    assert spans and all(s.t1 >= s.t0 for s in spans)
    st = eng.stats
    for k in ("admit_s", "prefill_s", "copy_s", "dispatch_s", "process_s",
              "compact_s"):
        assert st[k] >= 0.0, k
    for h in eng.hist.values():
        assert h.total >= 0.0
    (q,) = by_name(spans, "queue")
    assert abs(eng.hist["queue_wait"].total * 1e9 - (q.t1 - q.t0)) < 1.0
    assert abs(st["dispatch_s"] * 1e9
               - sum(s.t1 - s.t0 for s in by_name(spans, "dispatch"))) < 1.0


def test_stamps_are_the_wall_clock(eng):
    trace.enable()
    before = time.time()
    tid, _ = submit(eng, TtsArgs(text="wall clock", seed=4, max_tokens=2))
    after = time.time()
    got = trace.export()
    stamps = [t for s in got["spans"] for t in (s.t0, s.t1)]
    stamps += [m.t for m in got["marks"]]
    assert stamps and got["marks"]
    lo, hi = before * 1e9 - 5 * MS, after * 1e9 + 5 * MS
    assert all(lo <= t <= hi for t in stamps)


# --------------------------------------------------------------------------
# the vocoder and the stream
# --------------------------------------------------------------------------

class _Ids:
    """The engine as ``stream_synthesize`` sees it, keeping each id
    ``submit`` returns (``keep=False``: dropping it, as a wrapper may)."""

    def __init__(self, engine, keep=True):
        self._engine, self.keep, self.ids = engine, keep, []

    def submit(self, *a, **k):
        tid = self._engine.submit(*a, **k)
        self.ids.append(tid)
        return tid if self.keep else None

    def __getattr__(self, name):
        return getattr(self._engine, name)


def test_stream_records_windows_and_chunks_under_the_submit_id(eng,
                                                               bc_params):
    trace.enable()
    spy = _Ids(eng)
    args = TtsArgs(text="stream this", seed=6, max_tokens=12)
    chunks = list(stream_synthesize(spy, bc_params, BC_CFG, args,
                                    latency_mode="flash", timeout=WAIT))
    (tid,) = spy.ids
    got = trace.export()
    windows = by_name(got["spans"], "window", req=tid)
    reads = by_name(got["spans"], "vocode.readback", req=tid)
    marks = [m for m in got["marks"] if m.name == "chunk"]
    assert chunks[-1].final
    assert [m.req for m in marks] == [tid] * len(chunks)
    assert [m.n for m in marks] == [c.audio.size for c in chunks]
    # flash: interior windows of 8 tokens, then the flush of the rest
    sv = StreamingVocoder(bc_params, BC_CFG, None, latency_mode="flash")
    assert len(windows) == len(reads) >= 1
    assert {r.cause for r in reads} == {w.id for w in windows}
    assert {w.n for w in windows[:-1]} <= {sv.window_bucket}
    assert windows[-1].n == sv.flush_bucket
    (q,) = by_name(got["spans"], "queue", req=tid)
    assert q.t1 <= windows[0].t0 <= windows[0].t1 <= marks[0].t
    assert windows[-1].t1 <= marks[-1].t


def test_stream_through_a_wrapper_that_drops_the_id(eng, bc_params):
    trace.enable()
    spy = _Ids(eng, keep=False)
    chunks = list(stream_synthesize(
        spy, bc_params, BC_CFG, TtsArgs(text="wrapped", seed=7,
                                        max_tokens=8),
        latency_mode="flash", timeout=WAIT))
    got = trace.export()
    assert chunks[-1].final and len(spy.ids) == 1
    assert by_name(got["spans"], "queue", req=spy.ids[0])
    assert [m.req for m in got["marks"] if m.name == "chunk"] == \
        [0] * len(chunks)
    assert {w.req for w in by_name(got["spans"], "window")} == {0}


def test_pipeline_vocode_is_a_span_under_the_result_id(bc_params):
    pipe = types.SimpleNamespace(bicodec_params=bc_params,
                                 bicodec_cfg=BC_CFG, decode_graphs=None)
    gen = GenerationResult([0] * 32, [1, 2, 3, 4], 4, 36, trace_id=41)
    quiet = TtsPipeline.vocode(pipe, gen)
    trace.enable()
    wav = TtsPipeline.vocode(pipe, gen)
    np.testing.assert_array_equal(wav, quiet)
    spans = trace.export()["spans"]
    (v,) = by_name(spans, "vocode")
    (r,) = by_name(spans, "vocode.readback")
    assert (v.req, v.n, r.req, r.cause, r.n) == (41, 4, 41, v.id, 4)
    assert v.t0 <= r.t0 <= r.t1 <= v.t1
    # an empty generation vocodes nothing
    trace.reset()
    TtsPipeline.vocode(pipe, GenerationResult([], [], 0, 0, trace_id=42))
    assert trace.export()["spans"] == []


# --------------------------------------------------------------------------
# on a card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_decode_graphs_turn_is_recorded_under_the_bound_request(cuda_card):
    p = bicodec.init_params(BC_CFG, device="cuda")
    dg = bicodec.decode_graphs(p, BC_CFG)
    g, s = [[1] * 32], [[2] * 64]
    bicodec.decode_host(p, g, s, BC_CFG, dg)         # captures, unrecorded
    dg.cache.turns, dg.cache.wait_s = 0, 0.0
    trace.enable()
    with trace.request(11):
        with trace.scope("window", n=64) as sid:
            bicodec.decode_host(p, g, s, BC_CFG, dg)
        bicodec.decode_host(p, g, [[3] * 128], BC_CFG, dg)   # a new shape
    torch.cuda.synchronize()
    got = trace.export()
    waits = by_name(got["spans"], "turn.wait", req=11)
    turns = by_name(got["spans"], "turn", req=11)
    assert [w.cause for w in waits] == [t.cause for t in turns] == [sid, 0]
    for w, t in zip(waits, turns):
        assert w.t0 <= w.t1 == t.t0 <= t.t1
    assert dg.cache.turns == 2
    assert abs(dg.cache.wait_s * 1e9 - sum(w.t1 - w.t0 for w in waits)) < 1


@pytest.mark.cuda
def test_span_around_a_replay_encloses_its_kernels_in_kineto(cuda_card):
    """The shared clock: a span taken with ``trace.now()`` around a graph
    replay and ``synchronize()``, as ``export()`` hands it over, holds the
    replay's kernels as Kineto stamps them, each edge within 0.5 ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(1024, 1024, device="cuda")
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x
        for _ in range(20):
            y = torch.tanh(y @ x)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        y = x
        for _ in range(20):
            y = torch.tanh(y @ x)
    graph.replay()
    torch.cuda.synchronize()
    trace.enable()
    edges = []
    for _ in range(3):                    # Kineto now and then drops one
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trace.reset()
            torch.cuda.synchronize()
            t0 = trace.now()
            graph.replay()
            torch.cuda.synchronize()
            trace.span("replay", t0, trace.now())
        ks = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
        if ks:
            (sp,) = by_name(trace.export()["spans"], "replay")
            first = min(e.start_ns() for e in ks)
            last = max(e.start_ns() + e.duration_ns() for e in ks)
            edges = [first - sp.t0, sp.t1 - last]
            break
    assert edges, "no device event in three traces"
    for e in edges:
        assert 0 <= e <= MS // 2, edges
