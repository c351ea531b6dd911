"""The JAX package's serving layout, a bf16 recurrent state
(``RwkvConfig(state_dtype="bfloat16")``, ``tools/soak_serving.py``,
``tools/profile_buckets.py``, ``bench.py``), through every single-card
engine of the port, at the goldens shape.

A bf16 state rounds the f32 WKV update once a layer and a step. Two
programs whose f32 sums run in another order (the JAX model and the port,
or one request alone and inside a batch: a CPU product's bits depend on
its row count) then round a state element differently wherever its f32
value lies within their difference of a bf16 rounding midpoint. Each such
flip moves the element by one bf16 ulp; the logits stay within
``TIE_ENVELOPE`` of each other, and a draw whose pick a perturbation that
small changes parts the two token streams. So:

  * where the programs' bits must agree (the graphed protocol against the
    eager engine, one burst through the continuous engine against the
    static engine at its shapes), the tokens and the state's bits are held
    equal;
  * where they need not (the JAX engine against the port; the continuous
    engine over staggered admissions, buckets and a relocation against the
    static engine), each request's tokens are held equal, or its parting is
    shown to be such a near-tie: along the common tokens the logits agree
    within the envelope (with an f32 state within 1e-5), at the parting a
    perturbation within the envelope changes the pick, and the state's
    first differences are single-ulp roundings of f32 values that straddle
    a bf16 midpoint.

A bf16 state must stay bf16, with the same bits, through admission,
relocation and compaction.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch import constants as C
from rwkv_tts_tpu_torch.config import EngineConfig, RwkvConfig, TtsArgs
from rwkv_tts_tpu_torch.models import rwkv7 as P
from rwkv_tts_tpu_torch.runtime import continuous as CT
from rwkv_tts_tpu_torch.runtime import engine as E
from rwkv_tts_tpu_torch.runtime import graphs
from rwkv_tts_tpu_torch.utils import bridge, threefry
from test_torch_graphs import EagerCache


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GCFG = dict(chip_smoke.GOLDENS_CFG, state_dtype="bfloat16")
CFG = RwkvConfig(**GCFG)
ECFG = EngineConfig(prefill_buckets=(64, 128), max_semantic_tokens=16)
REQUESTS = chip_smoke.goldens_requests(TtsArgs)
BF16 = torch.bfloat16
WAIT = 300.0
# the largest relative logits difference (of the largest logit) that bf16
# state rounding makes between two programs along the same tokens over a
# goldens request; an f32 state keeps them within F32_ENVELOPE
TIE_ENVELOPE = 3e-3
F32_ENVELOPE = 1e-5


@pytest.fixture()
def eager_graphs(monkeypatch):
    """``graphs.GraphCache`` is ``EagerCache``: the graph holders work on
    the CPU."""
    monkeypatch.setattr(graphs, "GraphCache", EagerCache)


@pytest.fixture(scope="module")
def jax_side():
    jax = pytest.importorskip("jax")
    from rwkv_tts_tpu.config import EngineConfig as JE
    from rwkv_tts_tpu.config import RwkvConfig as JC
    from rwkv_tts_tpu.config import TtsArgs as JArgs
    from rwkv_tts_tpu.models import rwkv7 as J
    from rwkv_tts_tpu.runtime.engine import TtsEngine as JEngine

    jcfg = JC(**GCFG)
    jp = J.init_params(jcfg, jax.random.PRNGKey(1234))
    jeng = JEngine(jp, jcfg, JE(prefill_buckets=ECFG.prefill_buckets,
                                max_semantic_tokens=16), use_pallas=False)
    made = {}

    def generate(name, args=None):
        if name not in made:
            a = args or REQUESTS[name]
            made[name] = jeng.generate(JArgs(**{
                f: getattr(a, f) for f in a.__dataclass_fields__}))
        return made[name]

    return {"J": J, "jcfg": jcfg, "jp": jp, "generate": generate,
            "JC": JC}


@pytest.fixture(scope="module")
def params(jax_side):
    return bridge.rwkv7_params(jax_side["jp"], "cpu")


@pytest.fixture(scope="module")
def static(params):
    return E.TtsEngine(params, CFG, ECFG, device="cpu")


def tokens(res):
    return list(res.global_tokens) + list(res.semantic_tokens)


def first_difference(a, b):
    n = min(len(a), len(b))
    return next((i for i in range(n) if a[i] != b[i]),
                None if len(a) == len(b) else n)


# --------------------------------------------------------------------------
# walking two programs along the same tokens
# --------------------------------------------------------------------------

def pick(logits, u, preset):
    """The sampler's pick from [V] logits (masked entries -inf) and the
    draw ``u``: ``ops.sampling`` as the engines call it."""
    return int(E._sample(logits[None], torch.tensor([float(u)]), preset)[0])


def moves_within(logits, u, preset, eps: float) -> bool:
    """Whether raising or lowering one logit by ``eps`` of the largest
    logit changes the pick: a near-tie at that scale (the top-k edge, the
    top-p edge or the draw's place in the CDF). The tokens tried are the
    top-k + 1."""
    fin = torch.isfinite(logits)
    step = eps * float(logits[fin].abs().max())
    t0 = pick(logits, u, preset)
    cand = torch.topk(torch.where(fin, logits, torch.full_like(logits, -1e30)),
                      preset["top_k"] + 1).indices.tolist()
    for j in cand:
        for s in (step, -step):
            x = logits.clone()
            x[j] += s
            if pick(x, u, preset) != t0:
                return True
    return False


def rel(a, b) -> float:
    fin = torch.isfinite(a)
    return float((a[fin] - b[fin]).abs().max() / a[fin].abs().max())


def draws(args):
    """The global and semantic draws of a request (the engines' streams)."""
    def u(off, n):
        keys = threefry.as_words(np.stack([threefry.raw_key(args.seed + off)]))
        return threefry.step_uniforms(keys, n)[0]
    return u(C.GLOBAL_SEED_OFFSET, C.GLOBAL_TOKENS_SIZE), \
        u(C.SEMANTIC_SEED_OFFSET, ECFG.max_semantic_tokens)


def jax_walk(jax_side, params, cfg, jcfg, prompt, args, toks):
    """The JAX model and the port stepped along ``toks`` (a request's
    global then semantic tokens) from ``prompt`` at batch 1. Yields, per
    draw: (logits JAX [8320], logits port, draw, preset), the logits
    masked to the draw's domain. The zero-shot EOS gate is not modelled:
    a test that reads a pick checks it against its engine's token."""
    J = jax_side["J"]
    jp = jax_side["jp"]
    T = ECFG.prefill_buckets[0]
    tm = np.zeros((1, T), np.int32)
    tm[0, :len(prompt)] = prompt
    lens = np.array([len(prompt)], np.int32)
    lj, sj = J.forward(jp, tm, J.init_state(jcfg, 1), jcfg, lengths=lens)
    lt, st = P.forward(params, torch.from_numpy(tm).long(),
                       P.init_state(cfg, 1, device="cpu"), cfg,
                       lengths=torch.from_numpy(lens).long())
    ug, us = draws(args)
    if args.zero_shot:
        plan = [(t, us[i], C.SEMANTIC_SAMPLING, E._mask_semantic, t)
                for i, t in enumerate(toks)]
    else:
        g = toks[:C.GLOBAL_TOKENS_SIZE]
        plan = [(t, ug[i], C.GLOBAL_SAMPLING, E._mask_global,
                 t + C.GLOBAL_TOKEN_OFFSET) for i, t in enumerate(g)]
        plan.append((None, None, None, None, C.TTS_TAG_1))
        plan += [(t, us[i], C.SEMANTIC_SAMPLING, E._mask_semantic, t)
                 for i, t in enumerate(toks[C.GLOBAL_TOKENS_SIZE:])]
    hs = E.SEMANTIC_SLICE
    for tok, u, preset, mask, feed in plan:
        if tok is not None:
            a = mask(torch.from_numpy(np.asarray(lj)[0, :hs].copy()))
            b = mask(lt[0, :hs])
            yield a, b, u, preset
        lj, sj = J.step(jp, np.array([feed], np.int32), sj, jcfg,
                        head_slice=hs)
        lt, st = P.step(params, torch.tensor([feed]), st, cfg, head_slice=hs)


def bf16_midpoint_straddle(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Whether f32 values ``x`` and ``y`` lie on the two sides of one bf16
    rounding midpoint (they round to neighbouring bf16 values)."""
    bx, by = x.to(BF16), y.to(BF16)
    hi = torch.maximum(bx.float(), by.float())
    lo = torch.minimum(bx.float(), by.float())
    mid = (hi + lo) / 2
    return (torch.nextafter(lo.to(BF16), hi.to(BF16)).float() == hi) & \
        (torch.minimum(x, y) <= mid) & (torch.maximum(x, y) >= mid)


# --------------------------------------------------------------------------
# the port's engines against each other
# --------------------------------------------------------------------------

def graphed_static(params):
    eng = E.TtsEngine(params, CFG, ECFG, device="cpu")
    eng.graphs = E.StageGraphs(eng.params, CFG, eng.device)
    eng.prefill_graphs = E.PrefillGraphs(eng.params, CFG, eng.device)
    return eng


def graphed_continuous(params, ecfg, **kw):
    """A CPU ``ContinuousEngine`` whose blocks and admission prefill run
    through ``BlockGraphs`` and ``PrefillGraphs`` (the card's path)."""
    eng = CT.ContinuousEngine(params, CFG, ecfg, device="cpu", **kw)
    eng.graphs = CT.BlockGraphs(eng.params, CFG, eng.state, eng.logits,
                                eng.slots, eng.block)
    eng.prefill_graphs = E.PrefillGraphs(eng.params, CFG, eng.device,
                                         cache=eng.graphs.cache)
    return eng


# the staggered schedule: (block after which the decode thread enqueues
# it, name, args). Four short zero-shot requests and one long normal one
# go in as one burst (slots 0-4, the whole batch of 8); the short ones
# retire and the long one is relocated from slot 4 to slot 0 (bucket 2);
# three more arrive while it runs (buckets 2 and 4)
SCHEDULE = (
    (0, "zs_a", TtsArgs(text="first clone", seed=21, zero_shot=True,
                        max_tokens=4, ref_global_tokens=list(range(32)))),
    (0, "zs_b", TtsArgs(text="短", seed=22, zero_shot=True, max_tokens=5,
                        ref_global_tokens=[7] * 32)),
    (0, "zs_c", TtsArgs(text="third", seed=23, zero_shot=True,
                        max_tokens=3, ref_global_tokens=[3, 9] * 16)),
    (0, "zs_d", TtsArgs(text="the fourth one", seed=24, zero_shot=True,
                        max_tokens=4, ref_global_tokens=[1] * 32)),
    (0, "long", TtsArgs(text="golden fixture text", seed=42,
                        max_tokens=16)),
    (4, "late_normal", TtsArgs(text="你好世界", seed=7, max_tokens=12,
                               gender="male", emotion="HAPPY",
                               speed="fast")),
    (4, "late_zs", TtsArgs(text="clone fixture", seed=3, zero_shot=True,
                           max_tokens=16,
                           ref_global_tokens=list(range(32)))),
    (6, "later", TtsArgs(text="w", seed=11, zero_shot=True, max_tokens=16,
                         ref_global_tokens=[5] * 32)),
)


def scheduled(eng, schedule=SCHEDULE):
    """Run ``schedule`` through ``eng`` deterministically: the block-0
    requests as one burst, each later one enqueued by the decode thread
    right after it dispatched that block (so admissions, buckets and
    relocations do not depend on timing). Returns ({name: result}, the
    slots each block ran on)."""
    got, done = {}, threading.Event()
    n = len(schedule)

    def mk(name):
        def cb(res):
            got[name] = res
            if len(got) == n:
                done.set()
        return cb

    later = [(b, name, args) for b, name, args in schedule if b > 0]
    slots, real = [], eng._decode

    def hooked(bucket):
        slots.append(min(bucket, eng.B))
        out = real(bucket)
        for b, name, args in later:
            if b == eng._block_seq + 1:
                eng._enqueue(args, mk(name), None)
        return out

    eng._decode = hooked
    try:
        eng.submit_burst([(args, mk(name), None)
                          for b, name, args in schedule if b == 0])
        assert done.wait(WAIT), f"only {sorted(got)} finished"
    finally:
        eng.stop()
    for name, res in got.items():
        assert not isinstance(res, Exception), (name, res)
    return got, slots


@pytest.fixture(scope="module")
def staggered(params):
    """The schedule through the eager continuous engine and through the
    graphed protocol (8 slots, buckets 2 and 4, block 4), once each."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for kind in ("eager", "graphed"):
            ecfg = dataclasses.replace(ECFG, batch_size=8)
            if kind == "graphed":
                mp.setattr(graphs, "GraphCache", EagerCache)
                eng = graphed_continuous(params, ecfg, block=4, slots=8,
                                         buckets=(2, 4))
            else:
                eng = CT.ContinuousEngine(params, CFG, ecfg, device="cpu",
                                          block=4, slots=8, buckets=(2, 4))
            got, slots = scheduled(eng)
            out[kind] = (eng, got, slots)
    finally:
        mp.undo()
    return out


def test_schedule_admits_staggered_relocates_and_changes_bucket(staggered):
    """The schedule does what it is for: admissions after the first
    burst, a relocation, blocks on the whole batch and on both buckets."""
    eng, got, slots = staggered["eager"]
    assert len(got) == len(SCHEDULE)
    assert eng.stats["relocations"] >= 1
    assert eng.stats["admitted"] == len(SCHEDULE)
    assert {2, 4, 8} <= set(slots), slots


def test_graphed_continuous_equals_eager_at_bf16_state(staggered):
    """The graphed protocol (block and admission prefill replayed from
    their static buffers) against the eager continuous engine over the
    same schedule: the same tokens, the same blocks, and the final state
    the same bits."""
    e_eng, e_got, e_slots = staggered["eager"]
    g_eng, g_got, g_slots = staggered["graphed"]
    for name in e_got:
        assert tokens(g_got[name]) == tokens(e_got[name]), name
    assert g_slots == e_slots
    for k in e_eng.state:
        assert g_eng.state[k].dtype == e_eng.state[k].dtype
        assert torch.equal(g_eng.state[k], e_eng.state[k]), k
    assert {k[0] for k in g_eng.graphs.cache.programs} >= {"draws", "step"}


def test_continuous_state_stays_bf16(staggered):
    """The engine's state, allocated bf16, is still the same bf16 tensors
    after admissions, relocations and compaction (the graphs address
    them)."""
    for kind, (eng, _, _) in staggered.items():
        assert eng.state["wkv"].dtype == BF16, kind
        assert eng.state["att_x"].dtype == torch.float32
    g = staggered["graphed"][0]
    assert g.graphs.state["wkv"] is g.state["wkv"]


@pytest.mark.parametrize("name", [n for _, n, _ in SCHEDULE])
def test_staggered_tokens_match_static_or_part_at_a_tie(staggered, static,
                                                        jax_side, params,
                                                        name):
    """Each scheduled request through the continuous engine against the
    static engine alone (batch 1): the same tokens, or they part where
    the static engine's pick moves under a perturbation within the bf16
    envelope (the continuous engine's rows shared a batch, whose products
    round otherwise)."""
    _, got, _ = staggered["eager"]
    args = dict((n, a) for _, n, a in SCHEDULE)[name]
    want = static.generate(args)
    a, b = tokens(got[name]), tokens(want)
    i = first_difference(a, b)
    if i is None:
        return
    walk = list(jax_walk(jax_side, params, CFG, jax_side["jcfg"],
                         static.build_prompt(args)[0], args, b))
    _, lt, u, preset = walk[i]
    assert pick(lt, u, preset) == b[i]
    assert moves_within(lt, u, preset, TIE_ENVELOPE), (name, i)


@pytest.mark.parametrize("names", [("normal_seed42", "normal_chinese"),
                                   ("zero_shot", "zero_shot_window")])
def test_burst_at_static_shapes_equals_static(params, static, names):
    """One burst through the continuous engine at the static engine's
    shapes (as many slots as requests, no buckets) against
    ``generate_batch`` of the same requests: the same tokens (bf16
    rounding is the same where the products are)."""
    reqs = [REQUESTS[n] for n in names]
    want = static.generate_batch(reqs)
    eng = CT.ContinuousEngine(params, CFG,
                              dataclasses.replace(ECFG, batch_size=2),
                              device="cpu", block=4, slots=2, buckets=())
    got, done = {}, threading.Event()

    def mk(n):
        def cb(res):
            got[n] = res
            if len(got) == len(names):
                done.set()
        return cb

    try:
        eng.submit_burst([(r, mk(n), None) for n, r in zip(names, reqs)])
        assert done.wait(WAIT)
    finally:
        eng.stop()
    for n, w in zip(names, want):
        assert tokens(got[n]) == tokens(w), n


@pytest.mark.parametrize("name", list(REQUESTS))
def test_graphed_static_equals_eager_at_bf16_state(eager_graphs, static,
                                                   params, name):
    """The static engine's graphed stages and prefill (``StageGraphs``,
    ``PrefillGraphs``) against its eager stages, one request and then the
    goldens batch."""
    eng = graphed_static(params)
    assert tokens(eng.generate(REQUESTS[name])) == \
        tokens(static.generate(REQUESTS[name]))
    assert eng.graphs.sets[1]["state"]["wkv"].dtype == BF16
    assert all(b["state"]["wkv"].dtype == BF16
               for k, b in eng.prefill_graphs.sets.items()
               if isinstance(k, int))


def test_graphed_static_batch_equals_eager_at_bf16_state(eager_graphs,
                                                         static, params):
    eng = graphed_static(params)
    names = ("normal_seed42", "normal_chinese")
    got = eng.generate_batch([REQUESTS[n] for n in names])
    want = static.generate_batch([REQUESTS[n] for n in names])
    assert [tokens(r) for r in got] == [tokens(r) for r in want]


# --------------------------------------------------------------------------
# admission, relocation and compaction keep a bf16 state's bits
# --------------------------------------------------------------------------

def bf16_stack(B, seed):
    gen = torch.Generator().manual_seed(seed)
    st = P.init_state(CFG, B, device="cpu")
    for v in st.values():
        v.copy_(torch.randn(v.shape, generator=gen).to(v.dtype))
    return st


def test_insert_burst_keeps_bf16_bits():
    """``_insert_burst`` scatters a bf16 prefill state into a bf16 slot
    stack: the same bits at the target slots, the others untouched, the
    stack still the same bf16 tensor."""
    live, new = bf16_stack(8, 1), bf16_stack(2, 2)
    before = {k: v.clone() for k, v in live.items()}
    wkv = live["wkv"]
    logits = torch.zeros((8, 16))
    idx = torch.tensor([5, 2])
    live, _ = CT._insert_burst(live, logits, new, torch.ones((2, 16)), idx)
    assert live["wkv"] is wkv and wkv.dtype == BF16
    for k in live:
        assert torch.equal(live[k][:, idx], new[k]), k
        keep = [i for i in range(8) if i not in (5, 2)]
        assert torch.equal(live[k][:, keep], before[k][:, keep]), k


def test_relocate_keeps_bf16_bits():
    """``_relocate`` (compaction's move) copies the bf16 columns bit for
    bit in place and idles the sources."""
    st = bf16_stack(8, 3)
    before = {k: v.clone() for k, v in st.items()}
    wkv = st["wkv"]
    slots = CT.init_slots(8, "cpu")
    slots["stage"][6] = CT.SEMANTIC
    st, _, slots = CT._relocate(st, torch.zeros((8, 4)), slots,
                                torch.tensor([6]), torch.tensor([1]))
    assert st["wkv"] is wkv and wkv.dtype == BF16
    for k in st:
        assert torch.equal(st[k][:, 1], before[k][:, 6]), k
    assert int(slots["stage"][6]) == CT.IDLE
    assert int(slots["stage"][1]) == CT.SEMANTIC


def test_admission_inserts_the_prefill_bits(params):
    """Through the engine: the state a request is admitted with is the
    bf16 state its prefill produced, bit for bit, at its slot."""
    eng = CT.ContinuousEngine(params, CFG, dataclasses.replace(
        ECFG, batch_size=4), device="cpu", block=4, slots=4, buckets=())
    seen = []
    real = CT._insert_burst

    def spy(state, logits, new_state, new_logits, idx):
        out = real(state, logits, new_state, new_logits, idx)
        seen.append({k: (state[k][:, idx].clone(), new_state[k].clone())
                     for k in state})
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(CT, "_insert_burst", spy)
    try:
        eng.generate(dataclasses.replace(REQUESTS["zero_shot"],
                                         max_tokens=2))
    finally:
        mp.undo()
        eng.stop()
    assert seen
    for k, (slot, new) in seen[0].items():
        assert slot.dtype == new.dtype
        assert torch.equal(slot, new), k
    assert seen[0]["wkv"][0].dtype == BF16


# --------------------------------------------------------------------------
# the port against the JAX engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(REQUESTS))
def test_static_tokens_match_jax_or_part_at_a_tie(jax_side, params, static,
                                                  name):
    """The port's static engine against the JAX engine at a bf16 state:
    the same tokens, or, walking both models along the JAX tokens, the
    logits agree within ``TIE_ENVELOPE`` up to and at the parting draw,
    where the two picks differ (the port's pick is its engine's token)
    and a perturbation within the envelope moves the JAX side's pick."""
    want = tokens(jax_side["generate"](name))
    got = tokens(static.generate(REQUESTS[name]))
    i = first_difference(got, want)
    if i is None:
        return
    for j, (lj, lt, u, preset) in enumerate(
            jax_walk(jax_side, params, CFG, jax_side["jcfg"],
                     static.build_prompt(REQUESTS[name])[0], REQUESTS[name],
                     want)):
        assert rel(lj, lt) < TIE_ENVELOPE, (name, j)
        if j == i:
            assert pick(lt, u, preset) == got[i]
            assert pick(lj, u, preset) == want[i]
            assert moves_within(lj, u, preset, TIE_ENVELOPE)
            return
    raise AssertionError(f"{name}: no parting found along the walk")


@pytest.mark.parametrize("name", ["normal_seed42", "normal_chinese"])
def test_f32_state_walk_stays_within_f32_envelope(jax_side, params, static,
                                                  name):
    """The control: with an f32 state the same walk's logits agree within
    ``F32_ENVELOPE`` all the way (so the bf16 envelope is the state's
    rounding)."""
    fcfg = RwkvConfig(**chip_smoke.GOLDENS_CFG)
    jf = jax_side["JC"](**chip_smoke.GOLDENS_CFG)
    want = tokens(jax_side["generate"](name))
    worst = max(rel(lj, lt) for lj, lt, _, _ in
                jax_walk(jax_side, params, fcfg, jf,
                         static.build_prompt(REQUESTS[name])[0],
                         REQUESTS[name], want))
    assert worst < F32_ENVELOPE, worst


@pytest.mark.parametrize("name", ["normal_seed42", "normal_chinese"])
def test_first_state_differences_are_bf16_rounding_ties(jax_side, params,
                                                        static, name):
    """After the prompt's prefill the two bf16 states differ in a few
    elements. Each side's bf16 state is its own f32 state (the same prefill
    with an f32 state) rounded once, the two f32 states agree within 1e-6
    of their largest value, and every bf16 difference is no larger than
    the f32 difference plus one bf16 ulp: roundings of values that lie on
    the two sides of a bf16 rounding midpoint."""
    J = jax_side["J"]
    jf = jax_side["JC"](**chip_smoke.GOLDENS_CFG)
    fcfg = RwkvConfig(**chip_smoke.GOLDENS_CFG)
    prompt, _ = static.build_prompt(REQUESTS[name])
    tm = np.zeros((1, 64), np.int32)
    tm[0, :len(prompt)] = prompt
    lens = np.array([len(prompt)], np.int32)
    out = {}
    for tag, jc, pc in (("bf16", jax_side["jcfg"], CFG), ("f32", jf, fcfg)):
        _, sj = J.forward(jax_side["jp"], tm, J.init_state(jc, 1), jc,
                          lengths=lens)
        _, st = P.forward(params, torch.from_numpy(tm).long(),
                          P.init_state(pc, 1, device="cpu"), pc,
                          lengths=torch.from_numpy(lens).long())
        out[tag] = (torch.from_numpy(np.asarray(sj["wkv"]).astype(
            np.float32)), st["wkv"].float())
    jb, pb = out["bf16"]
    jf32, pf32 = out["f32"]
    diff = jb != pb
    assert 0 < int(diff.sum()) < diff.numel() // 100
    assert torch.equal(jf32.to(BF16).float(), jb)
    assert torch.equal(pf32.to(BF16).float(), pb)
    scale = float(jf32.abs().max())
    assert float((jf32 - pf32).abs().max()) < 1e-6 * scale
    big = torch.maximum(jb[diff].abs(), pb[diff].abs())
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    assert bool(((jb[diff] - pb[diff]).abs()
                 <= (jf32[diff] - pf32[diff]).abs() + ulp).all())
    assert bool(bf16_midpoint_straddle(jf32[diff], pf32[diff]).float()
                .mean() > 0.5)
