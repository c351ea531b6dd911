"""The port's continuous slot engine: the contracts of
``tests/test_continuous.py`` against the port's static engine (exact
tokens), and the port's engine against the JAX continuous engine on the four
goldens requests (exact tokens), at the goldens shape (2 layers × 128) on
the CPU. Every wait in here has a timeout, so a stuck decode thread fails
its test instead of hanging the suite."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch.config import EngineConfig, RwkvConfig, TtsArgs
from rwkv_tts_tpu_torch.models import rwkv7
from rwkv_tts_tpu_torch.runtime import continuous as CT
from rwkv_tts_tpu_torch.runtime.continuous import (ContinuousEngine,
                                                   RequestCancelled)
from rwkv_tts_tpu_torch.runtime.engine import TtsEngine
from rwkv_tts_tpu_torch.utils import bridge, trace


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = RwkvConfig(**chip_smoke.GOLDENS_CFG)
ECFG = EngineConfig(prefill_buckets=(32, 64), max_semantic_tokens=20,
                    batch_size=3)
WAIT = 300.0


@pytest.fixture(scope="module")
def params():
    return bridge.rwkv7_params(chip_smoke.goldens_params(CFG, 1234), "cpu")


@pytest.fixture(scope="module")
def static_engine(params):
    return TtsEngine(params, CFG, ECFG, device="cpu")


def engine(params, **kw):
    kw.setdefault("block", 8)
    kw.setdefault("slots", 3)
    return ContinuousEngine(params, CFG, kw.pop("ecfg", ECFG), device="cpu",
                            **kw)


@pytest.fixture()
def cont(params):
    eng = engine(params)
    yield eng
    eng.stop()


def same(got, want, what=""):
    assert got.global_tokens == want.global_tokens, what
    assert got.semantic_tokens == want.semantic_tokens, what


def collect(eng, reqs, submit=None):
    """Submit every request; returns {index: result} once all are in."""
    results, done = {}, threading.Event()

    def mk(i):
        def cb(res):
            results[i] = res
            if len(results) == len(reqs):
                done.set()
        return cb

    for i, r in enumerate(reqs):
        (submit or eng.submit)(r, mk(i))
    return results, done


def test_normal_mode_matches_static_engine(static_engine, cont):
    args = TtsArgs(text="parity check", seed=123, max_tokens=20)
    same(cont.generate(args, timeout=WAIT), static_engine.generate(args))


def test_zero_shot_matches_static_engine(static_engine, cont):
    args = TtsArgs(text="clone parity", seed=5, zero_shot=True,
                   max_tokens=20, ref_global_tokens=[3] * 32,
                   ref_semantic_tokens=[1, 2])
    same(cont.generate(args, timeout=WAIT), static_engine.generate(args))


def test_concurrent_mixed_requests(static_engine, cont):
    """More requests than slots, mixed modes, every one correct."""
    reqs = [TtsArgs(text=f"request number {i}", seed=i, max_tokens=12)
            for i in range(4)]
    reqs.append(TtsArgs(text="zs req", seed=99, zero_shot=True, max_tokens=12,
                        ref_global_tokens=[7] * 32, ref_semantic_tokens=[1]))
    results, done = collect(cont, reqs)
    assert done.wait(WAIT), f"only {len(results)}/{len(reqs)} finished"
    for i, r in enumerate(reqs):
        same(results[i], static_engine.generate(r), f"req {i}")


def test_chunk_callbacks_stream_all_tokens(cont):
    args = TtsArgs(text="stream me", seed=17, max_tokens=16)
    chunks, box, done = [], [], threading.Event()
    cont.submit(args, lambda r: (box.append(r), done.set()),
                chunk_cb=lambda req, toks: chunks.append(list(toks)))
    assert done.wait(WAIT)
    assert [t for c in chunks for t in c] == box[0].semantic_tokens
    assert len(box[0].semantic_tokens) == 16 and len(chunks) >= 2
    assert cont.hist["queue_wait"].n == 1 and cont.hist["first_emit"].n == 1


def test_long_prompt_admission(static_engine, cont):
    """A prompt longer than the largest prefill bucket admits through the
    chunked prefill."""
    args = TtsArgs(text="long " * 60, seed=21, max_tokens=10)
    assert len(cont.inner.build_prompt(args)[0]) > 64
    same(cont.generate(args, timeout=WAIT), static_engine.generate(args))


def test_bucketed_decode_matches_static_engine(params, static_engine):
    """With 8 slots and buckets (2, 4) one request decodes on the 2-slot
    prefix of the state (a view, never copied) and a burst of three on the
    4-slot one; slots above the bucket stay untouched."""
    eng = engine(params, slots=8, buckets=(2, 4))
    try:
        eng.state["wkv"][:, 4:] = 7.0
        args = TtsArgs(text="bucket parity", seed=77, max_tokens=20)
        same(eng.generate(args, timeout=WAIT), static_engine.generate(args))
        reqs = [TtsArgs(text=f"burst {i}", seed=100 + i, max_tokens=16)
                for i in range(3)]
        results, done = collect(eng, reqs)
        assert done.wait(WAIT)
        for i, r in enumerate(reqs):
            same(results[i], static_engine.generate(r), f"req {i}")
        eng.stop()
        assert bool((eng.state["wkv"][:, 4:] == 7.0).all())
    finally:
        eng.stop()


def test_bucket_selection_grows_and_shrinks(params):
    eng = engine(params, slots=8, buckets=(2, 4))
    try:
        assert [eng._bucket_for(n) for n in (1, 2, 3, 4, 5, 8)] == \
            [2, 2, 4, 4, 8, 8]
        for seed in (1, 2):
            res = eng.generate(TtsArgs(text="shrink", seed=seed,
                                       max_tokens=12), timeout=WAIT)
            assert len(res.global_tokens) == 32
        with eng._lock:
            assert not eng._live       # drained: the next lands in slot 0
    finally:
        eng.stop()


def test_compaction_relocates_straggler(params, static_engine):
    """A long request admitted into a high slot moves into a low free one
    once its burst-mates retire, and its tokens do not change."""
    eng = engine(params, block=4, slots=8, buckets=(2, 4))
    try:
        short = [TtsArgs(text=f"short {i}", seed=200 + i, max_tokens=2)
                 for i in range(2)]
        long = TtsArgs(text="the long straggler", seed=300, max_tokens=20)
        reqs = short + [long]
        # enqueue all three before the loop starts, so they admit as one
        # burst into slots 0, 1, 2: the straggler lands above bucket 2
        results, done = collect(eng, reqs, submit=lambda r, cb: eng._queue.put(
            [r, cb, None, trace.now(), False, 0]))
        eng.start()
        assert done.wait(WAIT), f"only {len(results)}/3 finished"
        assert eng.stats["relocations"] >= 1
        for i, r in enumerate(reqs):
            same(results[i], static_engine.generate(r), f"req {i}")
    finally:
        eng.stop()


def test_limit_zero_token_identical(static_engine, cont):
    req = TtsArgs(text="limit zero", seed=3, max_tokens=0)
    want = static_engine.generate(req)
    got = cont.generate(req, timeout=WAIT)
    assert want.semantic_tokens == [] and got.semantic_tokens == []
    assert got.global_tokens == want.global_tokens


def test_compaction_soak_random_traffic(params, static_engine):
    """Random admission order, mixed lengths and modes and mid-flight
    cancels under small buckets, so compaction fires repeatedly: every
    request that survives emits the static engine's tokens."""
    import random

    rng = random.Random(42)
    eng = engine(params, block=4, slots=8, buckets=(2, 4))
    try:
        reqs = []
        for i in range(12):
            n = rng.choice([2, 6, 12, 20])
            if i % 5 == 2:
                reqs.append(TtsArgs(
                    text=f"zs soak {i}", seed=500 + i, zero_shot=True,
                    max_tokens=n, ref_global_tokens=[i % 32] * 32,
                    ref_semantic_tokens=[1, 2, 3]))
            else:
                reqs.append(TtsArgs(text=f"soak request {i}", seed=500 + i,
                                    max_tokens=n))
        cancel_idx = {3, 8}
        step = {"i": 0}

        def submit(r, cb):
            eng.submit(r, cb)
            if step["i"] in cancel_idx:
                eng.cancel(r)           # may race completion: both are fine
            if step["i"] % 3 == 0:
                time.sleep(0.05)        # stagger admissions across blocks
            step["i"] += 1

        results, done = collect(eng, reqs, submit=submit)
        assert done.wait(600), f"only {len(results)}/{len(reqs)} finished"
        for i, r in enumerate(reqs):
            if isinstance(results[i], RequestCancelled):
                assert i in cancel_idx
                continue
            assert not isinstance(results[i], Exception), results[i]
            same(results[i], static_engine.generate(r), f"req {i}")
    finally:
        eng.stop()


def test_cancel_retires_slot(cont):
    done, box = threading.Event(), {}
    req = TtsArgs(text="a long cancelled request", seed=4, max_tokens=20)
    cont.submit(req, lambda r: (box.__setitem__("res", r), done.set()))
    assert cont.cancel(req) or done.wait(60.0)   # raced completion is fine
    assert done.wait(WAIT)
    if isinstance(box["res"], Exception):
        assert isinstance(box["res"], RequestCancelled)
    res = cont.generate(TtsArgs(text="after cancel", seed=5, max_tokens=8),
                        timeout=WAIT)
    assert len(res.global_tokens) == 32
    with cont._lock:
        assert not cont._live


def test_cancel_in_flight_of_the_final_block_ends_cancelled(params):
    """A cancel that returned True always ends in ``RequestCancelled``:
    the request is cancelled after the block that finishes it was
    dispatched and before the host processes that block (the order that
    once let the stream end normally). Forced deterministically by
    cancelling from inside ``_process_block`` when the block's stage
    snapshot shows the request's slot idle."""
    eng = engine(params)
    req = TtsArgs(text="race the final block", seed=6, max_tokens=4)
    box, done, fired = {}, threading.Event(), []
    process = eng._process_block

    def cancel_then_process(host, ev, seq):
        with eng._lock:
            slot = next((s for s, l in eng._live.items()
                         if l.request is req and l.admit_seq < seq), None)
        if slot is not None and not fired and \
                host.numpy()[-1][slot] == CT.IDLE:
            fired.append(eng.cancel(req))
        process(host, ev, seq)

    eng._process_block = cancel_then_process
    try:
        eng.submit(req, lambda r: (box.__setitem__("res", r), done.set()))
        assert done.wait(WAIT)
    finally:
        eng.stop()
    assert fired == [True]
    assert isinstance(box["res"], RequestCancelled), box["res"]
    with eng._lock:
        assert not eng._live


def test_concurrent_first_submits_single_decode_thread(params):
    """start() is atomic: eight threads submitting at once into a cold
    engine spawn one decode thread, and every request completes."""
    eng = engine(params)
    try:
        n = 8
        done, results, lock = threading.Event(), [], threading.Lock()

        def cb(res):
            with lock:
                results.append(res)
                if len(results) == n:
                    done.set()

        barrier = threading.Barrier(n)

        def submit_one(i):
            args = TtsArgs(text=f"racer {i}", seed=i, max_tokens=8)
            barrier.wait(timeout=60)
            eng.submit(args, cb)

        threads = [threading.Thread(target=submit_one, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        alive = [t for t in threading.enumerate()
                   if t.name == "continuous-decode" and t.is_alive()
                   and t is eng._thread]
        assert len(alive) == 1
        assert done.wait(600.0), f"only {len(results)}/{n} completed"
        assert all(not isinstance(r, Exception) for r in results)
    finally:
        eng.stop()


def test_cancel_before_admission_never_decodes(params):
    eng = engine(params, slots=1)      # one slot: the second submit queues
    try:
        blocker_done, victim_done, box = (threading.Event(),
                                          threading.Event(), {})
        blocker = TtsArgs(text="slot occupant", seed=1, max_tokens=20)
        victim = TtsArgs(text="queued then cancelled", seed=2, max_tokens=20)
        eng.submit(blocker, lambda r: blocker_done.set())
        eng.submit(victim,
                   lambda r: (box.__setitem__("res", r), victim_done.set()))
        assert eng.cancel(victim)       # not live yet: the queued path
        assert victim_done.wait(WAIT)
        assert isinstance(box["res"], RequestCancelled)
        assert blocker_done.wait(WAIT)
        assert not eng._queued          # registry drained, not leaked
        assert eng.stats["admitted"] == 1
    finally:
        eng.stop()


def test_crashed_loop_fast_fails_submits(params, monkeypatch):
    """A crashing decode loop fails its live and queued requests with the
    error, and later submits fail at once instead of queueing forever."""
    eng = engine(params, slots=1)
    try:
        def boom(*a, **k):
            raise RuntimeError("boom")

        monkeypatch.setattr(CT, "decode_block", boom)
        got, done = [], threading.Event()

        def cb(res):
            got.append(res)
            if len(got) == 2:
                done.set()

        eng.stop()
        for i in range(2):              # one admits, one stays queued
            eng._queue.put([TtsArgs(text=f"x{i}", seed=i), cb, None,
                            trace.now(), False, 0])
        eng.start()
        assert done.wait(WAIT)
        assert all(isinstance(r, RuntimeError) and "boom" in str(r)
                   for r in got)
        with pytest.raises(RuntimeError, match="offline"):
            eng.submit(TtsArgs(text="x", seed=1), lambda r: None)
    finally:
        eng.stop()


def test_warmup_then_token_identical(static_engine, cont):
    cont.warmup(timeout=WAIT)           # bursts of 1, 2, 3 at two buckets
    assert cont._crashed is None
    with cont._lock:
        assert not cont._live
    args = TtsArgs(text="after warmup", seed=321, max_tokens=20)
    same(cont.generate(args, timeout=WAIT), static_engine.generate(args))


def test_submit_burst_admits_together(params, static_engine):
    """``submit_burst`` on an idle engine: the requests are admitted in one
    burst (one prefill of the whole batch, in slot order) and emit the
    static engine's tokens; a burst onto live requests is refused."""
    eng = engine(params)
    try:
        reqs = [TtsArgs(text=f"burst request {i}", seed=40 + i, max_tokens=12)
                for i in range(3)]
        results, done = {}, threading.Event()

        def mk(i):
            def cb(res):
                results[i] = res
                if len(results) == len(reqs):
                    done.set()
            return cb

        eng.submit_burst([(r, mk(i), None) for i, r in enumerate(reqs)])
        assert done.wait(WAIT)
        assert eng.inner.counters["prefill_chunks"] == 1
        assert eng.stats["admitted"] == 3
        for i, r in enumerate(reqs):
            same(results[i], static_engine.generate(r), f"req {i}")

        gate, ended = threading.Event(), threading.Event()
        long = TtsArgs(text="still decoding", seed=1, max_tokens=20)
        eng.submit(long, lambda res: ended.set(),
                   chunk_cb=lambda req, toks: gate.wait(WAIT))
        deadline = time.time() + WAIT
        while not eng._live and time.time() < deadline:
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match="idle"):
            eng.submit_burst([(TtsArgs(text="late", seed=2, max_tokens=2),
                               lambda res: None, None)])
        gate.set()
        assert ended.wait(WAIT)     # the refusal left the loop running
    finally:
        eng.stop()


def test_block_keeps_its_stage_snapshot(params):
    """``decode_block`` returns new slot tensors and leaves the ones it was
    given as they were, so the snapshot the loop holds for block N is not
    rewritten by block N + 1."""
    eng = engine(params)
    try:
        eng._queue.put([TtsArgs(text="snap", seed=1, max_tokens=3),
                        lambda r: None, None, trace.now(), False, 0])
        eng._admit()
        before = {k: v.clone() for k, v in eng.slots.items()}
        held = dict(eng.slots)
        out = CT.decode_block(eng.params, eng.state, eng.logits, eng.slots,
                              CFG, 40)
        for k, v in held.items():
            assert torch.equal(v, before[k]), k
        assert int(out[2]["stage"][0]) == CT.IDLE       # 32 + 1 + 3 steps
        emits = out[3][:, 0].tolist()
        assert emits[:32] == [e for e in emits[:32] if e >= 0]
        assert emits[32] == CT.NO_EMIT and emits[36:] == [CT.NO_EMIT] * 4
    finally:
        eng.stop()


# --------------------------------------------------------------------------
# against the JAX continuous engine
# --------------------------------------------------------------------------

GOLDENS_ECFG = dict(prefill_buckets=(64, 128), max_semantic_tokens=48,
                    batch_size=4)


@pytest.fixture(scope="module")
def jax_side():
    jax = pytest.importorskip("jax")
    from rwkv_tts_tpu.config import EngineConfig as JE
    from rwkv_tts_tpu.config import RwkvConfig as JC
    from rwkv_tts_tpu.config import TtsArgs as JArgs
    from rwkv_tts_tpu.models import rwkv7 as J
    from rwkv_tts_tpu.runtime import continuous as JCT

    jcfg = JC(**chip_smoke.GOLDENS_CFG)
    jparams = J.init_params(jcfg, jax.random.PRNGKey(1234))
    return JCT, jcfg, JE(**GOLDENS_ECFG), jparams, JArgs


def test_goldens_requests_match_jax_continuous_engine(jax_side):
    """The four goldens requests, submitted together, through the JAX
    continuous engine and through the port's on the bridged weights: the
    same tokens and the same ``prefill_tokens`` and ``decode_steps``, and
    the tokens of ``tests/goldens.json`` (whose ``zero_shot_window``
    request is pinned at the static engine's cap of 16)."""
    JCT, jcfg, jecfg, jparams, JArgs = jax_side
    reqs = chip_smoke.goldens_requests(TtsArgs)
    jeng = JCT.ContinuousEngine(jparams, jcfg, jecfg, use_pallas=False,
                                block=8, slots=4)
    eng = ContinuousEngine(bridge.rwkv7_params(jparams, "cpu"), CFG,
                           EngineConfig(**GOLDENS_ECFG), block=8, slots=4,
                           device="cpu")
    try:
        jreqs = [JArgs(**{f: getattr(r, f) for f in r.__dataclass_fields__})
                 for r in reqs.values()]
        want, jdone = collect(jeng, jreqs)
        got, done = collect(eng, list(reqs.values()))
        assert jdone.wait(600) and done.wait(600)
    finally:
        jeng.stop()
        eng.stop()
    with open(os.path.join(os.path.dirname(__file__), "goldens.json")) as f:
        goldens = json.load(f)
    for i, name in enumerate(reqs):
        same(got[i], want[i], name)
        assert (got[i].prefill_tokens, got[i].decode_steps) == \
            (want[i].prefill_tokens, want[i].decode_steps), name
        assert got[i].global_tokens == goldens[name]["global"], name
        n = len(goldens[name]["semantic"])
        assert got[i].semantic_tokens[:n] == goldens[name]["semantic"], name


def test_decode_block_from_a_bridged_jax_state(jax_side):
    """A JAX engine's mid-flight state, logits and slot dict carried across
    as numpy (``bridge.continuous_state``): one more block from there emits
    the same tokens and leaves the same slot fields on both sides."""
    import jax

    JCT, jcfg, jecfg, jparams, JArgs = jax_side
    jeng = JCT.ContinuousEngine(jparams, jcfg, jecfg, use_pallas=False,
                                block=8, slots=4)
    reqs = chip_smoke.goldens_requests(JArgs)
    for r in (reqs["normal_seed42"], reqs["zero_shot_window"]):
        jeng._queue.put([r, lambda res: None, None, time.perf_counter(),
                         False])
    jeng._admit()
    st, lg, sl, _ = JCT.decode_block(jeng.params, jeng.state, jeng.logits,
                                     jeng.slots, jcfg, 30, use_pallas=False)
    state, logits, slots = bridge.continuous_state(
        jax.device_get(st), np.asarray(lg), jax.device_get(sl), "cpu")
    assert slots["gkey"].dtype == torch.int64
    assert slots["zs"].dtype == torch.bool
    _, _, sl2, want = JCT.decode_block(jeng.params, st, lg, sl, jcfg, 12,
                                       use_pallas=False)
    _, _, slots2, got = CT.decode_block(
        bridge.rwkv7_params(jparams, "cpu"), state, logits, slots, CFG, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) >= 0).sum() > 12       # both slots emitted
    for k in ("stage", "override", "n_glob", "n_step", "nwin", "win"):
        np.testing.assert_array_equal(slots2[k].numpy(), np.asarray(sl2[k]),
                                      err_msg=k)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_bucketed_block_on_card_matches_whole_block(cuda_card):
    """On a card the bucketed block runs the decode kernel on a view of the
    state stack (its layer stride, no copy): the same emits and state as
    the block over all slots, slots above the bucket untouched."""
    p = bridge.rwkv7_params(chip_smoke.goldens_params(CFG, 1234), "cuda")
    eng = ContinuousEngine(p, CFG, ECFG, block=8, slots=8, buckets=(2, 4),
                           device="cuda")
    eng._queue.put([TtsArgs(text="view", seed=1, max_tokens=20),
                    lambda r: None, None, trace.now(), False, 0])
    eng._admit()
    state2 = {k: v.clone() for k, v in eng.state.items()}
    state2["wkv"][:, 2:] = 7.0
    eng.state["wkv"][:, 2:] = 7.0
    _, lg_a, sl_a, em_a = CT.decode_block(p, state2, eng.logits, eng.slots,
                                          CFG, 40)
    _, lg_b, sl_b, em_b = CT.decode_block_bucketed(
        p, eng.state, eng.logits, eng.slots, CFG, 40, 2)
    torch.cuda.synchronize()
    assert torch.equal(em_a[:, :2], em_b[:, :2])
    assert bool((em_b[:, 2:] == CT.NO_EMIT).all())
    assert bool((eng.state["wkv"][:, 2:] == 7.0).all())
    torch.testing.assert_close(eng.state["wkv"][:, :2], state2["wkv"][:, :2],
                               rtol=1e-4, atol=1e-5)
