"""The prefill, the vocoder's windows and the parity engine's step as CUDA
graphs (``engine.PrefillGraphs``, ``bicodec.DecodeGraphs``,
``parity.StepGraphs``), and the continuous engine's power-of-two admission
burst.

On the CPU ``EagerCache`` (``tests/test_torch_graphs.py``) stands in for
``graphs.GraphCache``: the programs' bodies replay eagerly on their static
buffers, which drives the graphed paths' protocol (inputs copied into the
buffers, the state carried in them, one turn at a time for shared
programs). The replayed paths must equal their eager oracles bit for bit,
the JAX package's results where it has one (``rwkv7.forward`` through the
engines' tokens, ``bicodec.decode`` at ``test_torch_bicodec``'s stated
tolerance, the JAX continuous engine's tokens, ``goldens_parity.json``),
and every captured body runs under ``HostReadGuard``.

On a card (``-m cuda``; skipped here) each graphed path equals its eager
oracle bit for bit with the same counted launches: the checks of
``chip_smoke.py``'s ``graphs`` phase at small shapes.
"""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch.config import (BiCodecConfig, EngineConfig,
                                       RwkvConfig, TtsArgs)
from rwkv_tts_tpu_torch.models import bicodec, rwkv7
from rwkv_tts_tpu_torch.runtime import continuous as CT
from rwkv_tts_tpu_torch.runtime import engine as E
from rwkv_tts_tpu_torch.runtime import graphs
from rwkv_tts_tpu_torch.runtime import parity as PR
from rwkv_tts_tpu_torch.runtime.streaming import StreamingVocoder
from rwkv_tts_tpu_torch.utils import bridge
from test_torch_bicodec import chain_close
from test_torch_graphs import (BF16, EagerCache, HostRead,  # noqa: F401
                               HostReadGuard, layout_params)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = RwkvConfig(**chip_smoke.GOLDENS_CFG)
ECFG = EngineConfig(prefill_buckets=(64, 128), max_semantic_tokens=16)
BC_CFG = BiCodecConfig.tiny()
# the kernel route's shapes (``ops/conv1d`` needs 96 channels) under bf16
BC_KERNEL_CFG = BiCodecConfig.tiny(dec_channels=384, conv_impl="mxu_fused",
                                   dtype="bfloat16")
PREFILL_LAYOUTS = ("bf16", "int8", "int4", "nf4", "fused")
ROOT = os.path.dirname(chip_smoke.__file__)


@pytest.fixture()
def eager_graphs(monkeypatch):
    """``graphs.GraphCache`` is ``EagerCache``: the graph holders work on
    the CPU."""
    monkeypatch.setattr(graphs, "GraphCache", EagerCache)


@pytest.fixture(scope="module")
def params():
    return bridge.rwkv7_params(chip_smoke.goldens_params(CFG, 1234), "cpu")


@pytest.fixture(scope="module")
def jax_codec():
    jax = pytest.importorskip("jax")
    from rwkv_tts_tpu.config import BiCodecConfig as JConfig
    from rwkv_tts_tpu.models import bicodec as J

    jcfg = JConfig.tiny()
    return J, jcfg, J.init_params(jcfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def bc_params(jax_codec):
    return bridge.bicodec_params(jax_codec[2], device="cpu")


@pytest.fixture(scope="module")
def kernel_bc_params():
    gen = torch.Generator().manual_seed(5)
    return bicodec.prepare_params(
        bicodec.init_params(BC_KERNEL_CFG, gen, "cpu"), BC_KERNEL_CFG)


def same_prefill(a, b):
    assert torch.equal(a[0], b[0])
    assert a[1].keys() == b[1].keys()
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k


# --------------------------------------------------------------------------
# the prefill
# --------------------------------------------------------------------------

def test_prefill_program_equals_forward(eager_graphs, params):
    """One chunk of three ragged prompts replayed from ``PrefillGraphs``:
    the logits and state of ``rwkv7.forward`` on the same chunk, bit for
    bit, through one (B, T) program."""
    eng = E.TtsEngine(params, CFG, ECFG, device="cpu")
    pg = E.PrefillGraphs(eng.params, CFG, eng.device)
    prompts = chip_smoke.seeded_prompts(np.random.default_rng(5), 3, 64,
                                        CFG.vocab_size)
    got = eng.prefill_on(pg, prompts, eng.init_state(3))
    (tok, lengths), = E.prefill_chunks(prompts, ECFG.prefill_buckets)
    want = rwkv7.forward(params, torch.from_numpy(tok), eng.init_state(3),
                         CFG, lengths=torch.from_numpy(lengths))
    same_prefill(got, want)
    assert set(pg.cache.programs) == {(3, 64)}
    assert eng.counters["prefill_chunks"] == 1


def test_prefill_programs_carry_a_long_prompt(eager_graphs, params):
    """A prompt of 300 tokens beside one of 20 (buckets 64 and 128): three
    chunks, the (2, 128) program twice and the (2, 64) program once, the
    state carried in the buffers and the short row's logits kept from the
    first chunk; bit for bit the eager prefill. A second batch of the same
    shape replays the same programs from the reloaded buffers."""
    eng = E.TtsEngine(params, CFG, ECFG, device="cpu")
    pg = E.PrefillGraphs(eng.params, CFG, eng.device)
    rng = np.random.default_rng(6)
    for _ in range(2):
        prompts = chip_smoke.seeded_prompts(rng, 2, 20, CFG.vocab_size,
                                            longest=300)
        got = eng.prefill_on(pg, prompts, eng.init_state(2))
        same_prefill(got, eng.prefill_on(None, prompts, eng.init_state(2)))
    progs = pg.cache.programs
    assert set(progs) == {(2, 128), (2, 64)}
    assert progs[(2, 128)].replays == 4 and progs[(2, 64)].replays == 2
    assert eng.counters["prefill_chunks"] == 12


def test_static_engine_prefill_graphs_emit_goldens(eager_graphs, params):
    """The goldens requests through a static engine whose prefill and
    stages both replay their programs."""
    with open(os.path.join(ROOT, "tests", "goldens.json")) as f:
        want = json.load(f)
    eng = E.TtsEngine(params, CFG, ECFG, device="cpu")
    eng.graphs = E.StageGraphs(eng.params, CFG, eng.device)
    eng.prefill_graphs = E.PrefillGraphs(eng.params, CFG, eng.device)
    for name, req in chip_smoke.goldens_requests(TtsArgs).items():
        res = eng.generate(req)
        assert res.global_tokens == want[name]["global"], name
        assert res.semantic_tokens == want[name]["semantic"], name
    assert all(k[0] == 1 for k in eng.prefill_graphs.cache.programs)


@pytest.mark.parametrize("layout", PREFILL_LAYOUTS)
def test_prefill_bodies_read_nothing_back(eager_graphs, layout_params,
                                          layout):
    """The prefill's captured body in every weight layout runs under the
    guard: no host read and no host-built tensor, in three replays."""
    p = layout_params[layout]
    pg = E.PrefillGraphs(p, BF16, torch.device("cpu"))
    bufs = pg._buffers(2, 16)
    bufs["tokens"].copy_(torch.randint(0, 500, (2, 16),
                                       generator=torch.Generator()
                                       .manual_seed(3)))
    bufs["lengths"].copy_(torch.tensor([16, 9]))
    pg._body(bufs)          # first use: packs and codebooks are built here
    with HostReadGuard():
        for _ in range(3):
            pg._body(bufs)


def test_guard_fails_on_a_planted_read_in_the_prefill(eager_graphs,
                                                      monkeypatch,
                                                      layout_params):
    """A prefill body that reads a value back fails the guard."""
    real = rwkv7.prompt_mask

    def planted(tokens, lengths):
        int(lengths.max())
        return real(tokens, lengths)

    pg = E.PrefillGraphs(layout_params["bf16"], BF16, torch.device("cpu"))
    bufs = pg._buffers(1, 16)
    monkeypatch.setattr(rwkv7, "prompt_mask", planted)
    with pytest.raises(HostRead):
        with HostReadGuard():
            pg._body(bufs)


# --------------------------------------------------------------------------
# the continuous engine's admission burst
# --------------------------------------------------------------------------

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
    return JCT, jcfg, JE, jparams, JArgs


def jax_burst(jeng, reqs):
    """``reqs`` ({name: args}) admitted into the JAX engine as one burst:
    enqueued while its decode thread is stopped, as its ``warmup`` does."""
    got, done = {}, threading.Event()

    def mk(name):
        def cb(res):
            got[name] = res
            if len(got) == len(reqs):
                done.set()
        return cb

    jeng.stop()
    for name, r in reqs.items():
        entry = [r, mk(name), None, time.perf_counter(), False]
        with jeng._lock:
            jeng._queued[id(r)] = entry
        jeng._queue.put(entry)
    jeng.start()
    assert done.wait(300.0), f"only {sorted(got)} finished"
    return got


def port_burst(eng, reqs):
    got, done = {}, threading.Event()

    def mk(name):
        def cb(res):
            got[name] = res
            if len(got) == len(reqs):
                done.set()
        return cb

    eng.submit_burst([(r, mk(n), None) for n, r in reqs.items()])
    assert done.wait(300.0), f"only {sorted(got)} finished"
    return got


@pytest.mark.parametrize("zero_shot", [False, True])
def test_power_of_two_burst_matches_jax_engine(eager_graphs, jax_side,
                                               zero_shot):
    """Bursts of 3 and then 5 requests (normal or zero-shot) admitted as
    one burst each into the JAX continuous engine and into the port's,
    whose admission prefill replays ``PrefillGraphs`` in its blocks'
    cache: the same tokens, and the port prefilled bursts padded to 4 and
    8 (the last prompt repeated, never scattered)."""
    JCT, jcfg, JE, jparams, JArgs = jax_side
    ecfg = dict(prefill_buckets=(64, 128), max_semantic_tokens=12,
                batch_size=8)
    texts = ("one", "a longer request text", "三个", "four four",
             "the fifth", "six", "seven", "eight")

    def burst(lo, n):
        return {f"r{i}": TtsArgs(text=texts[i], seed=50 + i,
                                 max_tokens=4 + 2 * i, zero_shot=zero_shot,
                                 ref_global_tokens=[i + 3] * 32 if zero_shot
                                 else None)
                for i in range(lo, lo + n)}

    def as_jax(reqs):
        return {n: JArgs(**{f.name: getattr(r, f.name)
                            for f in dataclasses.fields(r)})
                for n, r in reqs.items()}

    jeng = JCT.ContinuousEngine(jparams, jcfg, JE(**ecfg), use_pallas=False,
                                block=4, slots=8)
    eng = CT.ContinuousEngine(bridge.rwkv7_params(jparams, "cpu"), CFG,
                              EngineConfig(**ecfg), block=4, slots=8,
                              device="cpu")
    eng.graphs = CT.BlockGraphs(eng.params, CFG, eng.state, eng.logits,
                                eng.slots, eng.block)
    eng.prefill_graphs = E.PrefillGraphs(eng.params, CFG, eng.device,
                                         cache=eng.graphs.cache)
    try:
        for lo, n in ((0, 3), (3, 5)):
            reqs = burst(lo, n)
            jgot = jax_burst(jeng, as_jax(reqs))
            got = port_burst(eng, reqs)
            for name in reqs:
                assert got[name].global_tokens == jgot[name].global_tokens
                assert got[name].semantic_tokens == \
                    jgot[name].semantic_tokens, name
    finally:
        jeng.stop()
        eng.stop()
    widths = {k[0] for k in eng.graphs.cache.programs
              if isinstance(k[0], int)}
    assert widths == {4, 8}
    assert eng.stats["admitted"] == 8


def test_burst_pads_to_a_power_of_two_capped_at_the_slots(params):
    """Eagerly on the CPU: a burst of 3 prefills 4 prompts, a burst of 5
    over 6 slots prefills 6; the copies are never scattered (the tokens
    are the static engine's)."""
    seen = []
    for slots, n, want in ((8, 3, 4), (6, 5, 6)):
        eng = CT.ContinuousEngine(params, CFG, ECFG, block=4, slots=slots,
                                  device="cpu")
        real = eng.inner.prefill_on

        def spy(pg, prompts, state, real=real):
            seen.append(len(prompts))
            return real(pg, prompts, state)

        eng.inner.prefill_on = spy
        reqs = {f"q{i}": TtsArgs(text=f"burst {i}", seed=70 + i,
                                 max_tokens=5) for i in range(n)}
        try:
            got = port_burst(eng, reqs)
        finally:
            eng.stop()
        assert seen[-1] == want
        static = E.TtsEngine(params, CFG, ECFG, device="cpu")
        for name, r in reqs.items():
            res = static.generate(r)
            assert got[name].semantic_tokens == res.semantic_tokens, name


# --------------------------------------------------------------------------
# the vocoder's windows
# --------------------------------------------------------------------------

def window_tokens(seed, B=1, S=40, rows=8192):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4096, (B, 32)), rng.integers(0, rows, (B, S))


@pytest.mark.parametrize("which", ["native", "kernel"])
def test_window_bodies_read_nothing_back(eager_graphs, bc_params,
                                         kernel_bc_params, which):
    """The vocoder's captured body runs under the guard (three replays),
    native f32 and through ``ops/conv1d`` in bf16, and its program's
    output equals ``bicodec.decode`` bit for bit."""
    p, cfg = ((bc_params, BC_CFG) if which == "native"
              else (kernel_bc_params, BC_KERNEL_CFG))
    dg = bicodec.DecodeGraphs(p, cfg, "cpu")
    g, s = window_tokens(1, B=2, S=24)
    want = bicodec.decode(p, torch.from_numpy(g), torch.from_numpy(s), cfg)
    assert torch.equal(dg.decode(g, s), want)
    bufs = dg.sets[(2, 24)]
    with HostReadGuard():
        for _ in range(3):
            dg._body(bufs)
    assert torch.equal(bufs["wav"], want)


def test_window_program_matches_jax_decode(eager_graphs, jax_codec,
                                           bc_params):
    """The window program against the JAX package's ``bicodec.decode`` on
    the same weights and tokens, at ``test_torch_bicodec``'s chain
    tolerance."""
    J, jcfg, jp = jax_codec
    g, s = window_tokens(2, B=2, S=40)
    want = np.asarray(J.decode(jp, g.astype(np.int32), s.astype(np.int32),
                               jcfg))
    got = bicodec.DecodeGraphs(bc_params, BC_CFG, "cpu").decode(g, s)
    assert got.shape == (2, 40 * 320)
    chain_close(got.numpy(), want)


@pytest.fixture()
def routed(eager_graphs, bc_params):
    """One ``DecodeGraphs`` over the tiny tree that every caller is handed,
    as the pipeline hands its own on a card."""
    return bicodec.DecodeGraphs(bc_params, BC_CFG, "cpu")


def test_out_of_range_token_raises_through_the_graphed_paths(routed,
                                                             bc_params):
    """A semantic token past the codebook raises ``ValueError`` from
    ``StreamingVocoder`` and ``detokenize`` on the graphed route, before
    any token reaches a program's buffers; in-range tokens replay."""
    g, s = window_tokens(3, S=60)
    s[0, 45] = 9000
    sv = StreamingVocoder(bc_params, BC_CFG, list(g[0]), latency_mode="flash",
                          graphs=routed)
    with pytest.raises(ValueError, match="9000.*8192"):
        for i in range(0, 60, 10):
            sv.push([int(t) for t in s[0, i:i + 10]])
    with pytest.raises(ValueError, match="9000.*8192"):
        bicodec.detokenize(bc_params, g[0], s[0], BC_CFG, graphs=routed)
    assert all(p.replays for p in routed.cache.programs.values())
    n = sum(p.replays for p in routed.cache.programs.values())
    s[0, 45] = 17
    bicodec.detokenize(bc_params, g[0], s[0], BC_CFG, graphs=routed)
    assert sum(p.replays for p in routed.cache.programs.values()) == n + 1


def test_detokenize_replays_its_bucket(routed, bc_params):
    """``detokenize`` (and so ``TtsPipeline.vocode``) replays the program
    of its (B, padded) bucket and returns the eager samples bit for
    bit."""
    g, s = window_tokens(4, S=50)
    got = bicodec.detokenize(bc_params, g[0], s[0], BC_CFG, graphs=routed)
    padded = bicodec._detok_bucket(50 + bicodec.receptive_latents(BC_CFG),
                                   bicodec.DETOKENIZE_BUCKETS)
    assert set(routed.cache.programs) == {(1, padded)}
    want = bicodec.detokenize(bc_params, g[0], s[0], BC_CFG)
    np.testing.assert_array_equal(got, want)


def test_four_threads_share_the_window_programs(routed, bc_params):
    """Four threads stream four utterances at once through one set of
    window programs (interleaved turns on shared buffers): each gets
    exactly the samples of its own eager run."""
    def run(i, out, dg=None):
        g, s = window_tokens(10 + i, S=70)
        sv = StreamingVocoder(bc_params, BC_CFG, [int(t) for t in g[0]],
                              latency_mode=("flash", "ultra")[i % 2],
                              graphs=dg)
        parts = []
        for j in range(0, 70, 7):
            parts.append(sv.push([int(t) for t in s[0, j:j + 7]]))
        parts.append(sv.push([], flush=True))
        out[i] = np.concatenate(parts)

    graphed, threads = {}, []
    for i in range(4):
        threads.append(threading.Thread(target=run,
                                        args=(i, graphed, routed)))
        threads[-1].start()
    for t in threads:
        t.join(300.0)
    eager = {}
    for i in range(4):
        run(i, eager)
    for i in range(4):
        assert graphed[i].shape == (70 * 320,)
        np.testing.assert_array_equal(graphed[i], eager[i])
    assert sum(p.replays for p in routed.cache.programs.values()) > 8


def test_pipeline_vocodes_through_its_own_graphs(eager_graphs, params,
                                                 bc_params):
    """The pipeline owns its codec's ``DecodeGraphs`` (none on the CPU)
    and hands it to ``vocode``: given one, a request's detokenize replays
    its bucket's program, bit for bit the eager samples."""
    from rwkv_tts_tpu_torch.runtime.engine import GenerationResult
    from rwkv_tts_tpu_torch.runtime.pipeline import TtsPipeline

    pipe = TtsPipeline(params, CFG, bc_params, BC_CFG, engine_cfg=ECFG,
                       device="cpu")
    assert pipe.decode_graphs is None
    g, s = window_tokens(6, S=30)
    gen = GenerationResult([int(t) for t in g[0]], [int(t) for t in s[0]],
                           0, 0)
    want = pipe.vocode(gen)
    pipe.decode_graphs = bicodec.DecodeGraphs(pipe.bicodec_params, BC_CFG,
                                              "cpu")
    np.testing.assert_array_equal(pipe.vocode(gen), want)
    assert [p.replays for p in pipe.decode_graphs.cache.programs.values()] \
        == [1]


def test_stream_replays_the_graphs_it_is_handed(routed, params, bc_params):
    """``stream_synthesize(vocoder_graphs=)`` vocodes every window of a
    request through the programs it is handed (as the server hands the
    pipeline's), chunk for chunk the samples of the eager stream."""
    from rwkv_tts_tpu_torch.runtime.streaming import stream_synthesize

    eng = CT.ContinuousEngine(params, CFG, ECFG, block=8, slots=2,
                              device="cpu")
    try:
        args = TtsArgs(text="stream through graphs", seed=8, max_tokens=16)
        eager, graphed = (
            [c.audio for c in stream_synthesize(
                eng, bc_params, BC_CFG, args, chunk_tokens=8,
                latency_mode="flash", timeout=300.0, vocoder_graphs=dg)]
            for dg in (None, routed))
    finally:
        eng.stop()
    assert len(graphed) == len(eager) > 1
    for a, b in zip(graphed, eager):
        np.testing.assert_array_equal(a, b)
    assert sum(p.replays for p in routed.cache.programs.values()) \
        == len(graphed)


def test_decode_graphs_off_the_card(bc_params):
    """A tree on the CPU has no vocoder graphs: ``decode_host`` decodes
    eagerly."""
    assert bicodec.decode_graphs(bc_params, BC_CFG) is None
    g, s = window_tokens(5, S=8)
    want = bicodec.decode(bc_params, torch.from_numpy(g),
                          torch.from_numpy(s), BC_CFG)
    assert torch.equal(bicodec.decode_host(bc_params, g, s, BC_CFG), want)


def test_collector_off_holds_across_threads():
    """``graphs.collector_off`` keeps Python's cyclic collector off from the
    first hold to the end of the last, however the holds of two capturing
    threads interleave, and leaves it as it found it."""
    import gc

    assert gc.isenabled()
    first_in, second_in, first_out = (threading.Event() for _ in range(3))
    seen = []

    def first():
        with graphs.collector_off():
            first_in.set()
            second_in.wait(10.0)
            seen.append(gc.isenabled())
        first_out.set()

    t = threading.Thread(target=first)
    t.start()
    first_in.wait(10.0)
    with graphs.collector_off():
        second_in.set()
        first_out.wait(10.0)
        seen.append(gc.isenabled())
    t.join(10.0)
    assert seen == [False, False] and gc.isenabled()
    gc.disable()
    try:
        with graphs.collector_off():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()


# --------------------------------------------------------------------------
# the parity engine's step
# --------------------------------------------------------------------------

def test_graphed_parity_step_emits_goldens_parity(eager_graphs, params):
    """``tests/goldens_parity.json`` through ``ReferenceRngEngine`` with
    its step replayed from ``StepGraphs`` (one replay a decode step) and
    its prompt from the engine's ``PrefillGraphs``."""
    with open(os.path.join(ROOT, "tests", "goldens_parity.json")) as f:
        want = json.load(f)
    eng = E.TtsEngine(params, CFG, ECFG, device="cpu")
    eng.prefill_graphs = E.PrefillGraphs(eng.params, CFG, eng.device)
    pe = PR.ReferenceRngEngine(eng)
    pe.graphs = PR.StepGraphs(eng.params, CFG, eng.device)
    for name, req in chip_smoke.parity_requests(TtsArgs).items():
        res = pe.generate(req)
        assert {"global": res.global_tokens,
                "semantic": res.semantic_tokens} == want[name], name
    assert pe.graphs.cache.programs["step"].replays == \
        eng.counters["decode_steps"]
    assert eng.prefill_graphs.cache.programs


def test_parity_step_body_reads_nothing_back(eager_graphs, layout_params):
    """The parity step's captured body runs under the guard."""
    sg = PR.StepGraphs(layout_params["bf16"], BF16, "cpu")
    sg.advance([5], rwkv7.init_state(BF16, 1, device="cpu"))
    with HostReadGuard():
        for _ in range(3):
            sg._body(sg.bufs)


def test_parity_step_check_at_the_goldens_shape(eager_graphs, params):
    """``chip_smoke.parity_step_check`` (the chip phase's check) on the
    CPU: the replayed step equals ``rwkv7.step`` bit for bit."""
    r = chip_smoke.parity_step_check(torch, params, CFG, "cpu", tokens=6,
                                     profile=False)
    assert r["bitwise"], r
    assert r["launches"]["eager"] == r["launches"]["graphed"]


# --------------------------------------------------------------------------
# the chip phase's checks, rehearsed on the CPU
# --------------------------------------------------------------------------

def test_prefill_graph_check_at_the_goldens_shape(eager_graphs, params):
    r = chip_smoke.prefill_graph_check(torch, params, CFG, "cpu",
                                       shapes=((3, 64), (2, 128)),
                                       buckets=(64, 128), profile=False)
    assert {k for k in r if k != "programs"} == {"3x64", "2x128",
                                                 "two_chunk"}
    for case in ("3x64", "2x128", "two_chunk"):
        assert r[case]["bitwise"], (case, r[case])
    assert r["two_chunk"]["chunks"] == 2


def test_window_graph_check_at_tiny_shapes(eager_graphs, bc_params):
    r = chip_smoke.window_graph_check(torch, bc_params, BC_CFG, "cpu",
                                      batches=(1, 2), detok_buckets=(64,))
    kinds = [(c["kind"], c["B"]) for c in r["cases"]]
    assert ("detokenize", 2) in kinds and ("window", 1) in kinds
    assert all(c["bitwise"] for c in r["cases"]), r["cases"]


# --------------------------------------------------------------------------
# on a card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_graphed_prefill_equals_eager_on_card(cuda_card, quant):
    """4 layers × 512: the prefill replayed from ``PrefillGraphs`` equals
    the eager prefill bit for bit (one chunk at (8, 64), a two-chunk
    batch), with the same counted launches."""
    cfg = RwkvConfig(n_layer=4, n_embd=512, head_size=64)
    gen = torch.Generator(device="cuda").manual_seed(3)
    p = rwkv7.make_serving_params(cfg, gen, quant=quant, device="cuda")
    r = chip_smoke.prefill_graph_check(torch, p, cfg, "cuda",
                                       shapes=((8, 64),), profile=False)
    for case in ("8x64", "two_chunk"):
        assert r[case]["bitwise"], r[case]
        assert r[case]["launches"]["eager"] == r[case]["launches"]["graphed"]


@pytest.mark.cuda
def test_graphed_windows_equal_eager_on_card(cuda_card):
    """Every streaming window length and two detokenize buckets at B = 1
    and 2 through ``DecodeGraphs`` on a kernel-route BiCodec: the eager
    waveform bit for bit, the same counted launches."""
    cfg = BiCodecConfig.tiny(dec_channels=384, conv_impl="mxu_fused")
    gen = torch.Generator(device="cuda").manual_seed(4)
    p = bicodec.prepare_params(bicodec.init_params(cfg, gen, "cuda"), cfg)
    r = chip_smoke.window_graph_check(torch, p, cfg, "cuda", batches=(1, 2),
                                      detok_buckets=(64, 128))
    for c in r["cases"]:
        assert c["bitwise"], c
        assert c["launches"]["eager"] == c["launches"]["graphed"], c


@pytest.mark.cuda
def test_graphed_parity_step_equals_eager_on_card(cuda_card):
    cfg = RwkvConfig(n_layer=4, n_embd=512, head_size=64)
    gen = torch.Generator(device="cuda").manual_seed(5)
    p = rwkv7.make_serving_params(cfg, gen, device="cuda")
    r = chip_smoke.parity_step_check(torch, p, cfg, "cuda", tokens=8,
                                     profile=False)
    assert r["bitwise"], r
    assert r["launches"]["eager"] == r["launches"]["graphed"]


@pytest.mark.cuda
def test_graphed_parity_goldens_on_card(cuda_card):
    out = chip_smoke.parity_goldens("cuda", ROOT)
    assert out["step_replays"] == out["decode_steps"] > 0
