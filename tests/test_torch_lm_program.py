"""The port's one-call LM program (``runtime/engine.lm_program`` and
``TtsEngine.lm_program``), the counterpart of the JAX engine's
``lm_program`` (``rwkv_tts_tpu/runtime/engine.py:255``), at the goldens
shape on the CPU:

  * against the JAX ``lm_program`` (``use_pallas`` off) on the same bridged
    parameters, prompts and seeds, bf16 weights with an f32 state: tokens
    and lengths exactly, in both modes (under the bf16 compute policy the
    two packages round at different points, and the prefill's logits
    stand as far from each other as each from the f32 computation);
  * against the port's own staged chain (``TtsEngine.prefill``, then the
    global and the semantic stage), bit for bit, in int8 with a bf16 state
    (the JAX side parts from it there only at rounding ties, which
    ``test_torch_quant_engine`` and ``test_torch_bf16_serving`` pin), eager
    and through the graph holders (``EagerCache`` standing in for
    ``graphs.GraphCache``, as a card replays them);
  * ``TtsEngine.lm_program`` prefilling a prompt longer than the largest
    bucket in chunks, and ``generate_batch`` serving every batch through
    it, a single-chunk one in one chunk;
  * the pipeline's warm-up running its ``lm_*`` steps through
    ``TtsEngine.lm_program``, as the JAX warm-up runs ``lm_program``
    (``tests/test_codecs.py:279``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch import constants as C
from rwkv_tts_tpu_torch.config import (BiCodecConfig, EngineConfig,
                                       RwkvConfig, TtsArgs)
from rwkv_tts_tpu_torch.ops.quant import quantize_rwkv_params
from rwkv_tts_tpu_torch.runtime import engine as E
from rwkv_tts_tpu_torch.runtime import graphs
from rwkv_tts_tpu_torch.runtime.pipeline import TtsPipeline
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


# bf16 weights computed in f32, with an f32 state: the layout in which
# the two packages' sums agree to f32 rounding (the bf16 compute policy
# rounds at other points in each, ``test_bf16_compute_gap_is_rounding``)
BF16_WEIGHTS = dict(chip_smoke.GOLDENS_CFG, param_dtype="bfloat16")
CFG = RwkvConfig(**BF16_WEIGHTS)
# the JAX serving layout: int8 weights, bf16 compute and state
INT8_CFG = dataclasses.replace(CFG, dtype="bfloat16",
                               state_dtype="bfloat16")
ECFG = EngineConfig(prefill_buckets=(32, 64), max_semantic_tokens=16,
                    decode_block=4)
B, T = 4, 64
LIMITS = [16, 11, 16, 7]
ZS_HARD_MIN = [9, 0, 14, 3]
SEEDS = [42, 7, 3, 11]


@pytest.fixture(scope="module")
def jax_side():
    jax = pytest.importorskip("jax")
    from rwkv_tts_tpu.config import RwkvConfig as JC
    from rwkv_tts_tpu.models import rwkv7 as J
    from rwkv_tts_tpu.runtime import engine as JE

    jcfg = JC(**BF16_WEIGHTS)
    return JE, jcfg, J.init_params(jcfg, jax.random.PRNGKey(1234))


@pytest.fixture(scope="module")
def params(jax_side):
    return bridge.rwkv7_params(jax_side[2], "cpu")


@pytest.fixture(scope="module")
def int8_params(params):
    return quantize_rwkv_params(params, kind="int8")


@pytest.fixture()
def eager_graphs(monkeypatch):
    """``graphs.GraphCache`` is ``EagerCache``: the graph holders work on
    the CPU."""
    monkeypatch.setattr(graphs, "GraphCache", EagerCache)


def program_inputs(zero_shot: bool, seed: int = 5):
    """Ragged seeded prompts right-padded to T, both stages' keys from
    ``SEEDS``, per-request limits and (zero-shot) hard minimums, as host
    arrays."""
    prompts = chip_smoke.seeded_prompts(np.random.default_rng(seed), B, T,
                                        CFG.vocab_size)
    (tok, lengths), = E.prefill_chunks(prompts, (T,))
    return {"prompts": prompts, "tokens": tok, "lengths": lengths,
            "glob_keys": np.stack([threefry.raw_key(s + C.GLOBAL_SEED_OFFSET)
                                   for s in SEEDS]),
            "sem_keys": np.stack([threefry.raw_key(s + C.SEMANTIC_SEED_OFFSET)
                                  for s in SEEDS]),
            "limits": np.array(LIMITS, np.int64),
            "hard_min": np.array(ZS_HARD_MIN if zero_shot else [0] * B,
                                 np.int64)}


def torch_inputs(x):
    words = threefry.as_words
    return dict(tokens=torch.from_numpy(x["tokens"]),
                lengths=torch.from_numpy(x["lengths"]),
                glob_keys=words(x["glob_keys"]),
                sem_keys=words(x["sem_keys"]),
                limits=torch.from_numpy(x["limits"]),
                hard_min=torch.from_numpy(x["hard_min"]))


def assert_same(got, want, zero_shot: bool):
    """(glob, sem, lens) equal element for element."""
    glob, sem, lens = (np.asarray(v) for v in got)
    wglob, wsem, wlens = (np.asarray(v) for v in want)
    assert lens.tolist() == wlens.tolist()
    assert sem.tolist() == wsem.tolist()
    assert glob.tolist() == wglob.tolist()
    if zero_shot:
        assert not glob.any()


@pytest.mark.parametrize("zero_shot", [False, True])
def test_lm_program_equals_jax(jax_side, params, zero_shot):
    """The port's ``lm_program`` emits the JAX ``lm_program``'s tokens and
    lengths exactly: bf16 weights, an f32 state, 4 ragged prompts in one
    chunk, per-request limits (and hard minimums in zero-shot mode)."""
    import jax.numpy as jnp

    JE, jcfg, jp = jax_side
    x = program_inputs(zero_shot)
    i32 = jnp.int32
    want = JE.lm_program(
        jp, jnp.asarray(x["tokens"], i32), jnp.asarray(x["lengths"], i32),
        jnp.asarray(x["glob_keys"]), jnp.asarray(x["sem_keys"]),
        jnp.asarray(x["limits"], i32), jnp.asarray(x["hard_min"], i32),
        jcfg, ECFG.max_semantic_tokens, zero_shot, use_pallas_fwd=False,
        use_pallas_step=False)
    got = E.lm_program(params, cfg=CFG, max_steps=ECFG.max_semantic_tokens,
                       zero_shot=zero_shot, **torch_inputs(x))
    assert_same(got, want, zero_shot)
    # the requests drew semantic tokens, not only EOS
    assert np.asarray(got[2]).sum() > 0


def test_bf16_compute_gap_is_rounding(jax_side, params):
    """Under the bf16 compute policy the port's and the JAX prefill's
    logits part (the sums round at other points: XLA fuses elementwise
    chains in f32, eager torch rounds each op's output), but each stands
    as far from the f32 computation of the same bf16 weights as the other:
    a rounding policy, not a different function. So exact tokens are held
    with the weights computed in f32."""
    import jax.numpy as jnp

    JE, jcfg, jp = jax_side
    from rwkv_tts_tpu.models import rwkv7 as J
    from rwkv_tts_tpu_torch.models import rwkv7 as P

    x = program_inputs(False)
    tok, lengths = x["tokens"], x["lengths"]

    def jax_logits(cfg):
        lg, _ = J.forward(jp, jnp.asarray(tok, jnp.int32),
                          J.init_state(cfg, B), cfg,
                          lengths=jnp.asarray(lengths, jnp.int32))
        return np.asarray(lg, np.float32)

    def port_logits(cfg):
        lg, _ = P.forward(params, torch.from_numpy(tok),
                          P.init_state(cfg, B, device="cpu"), cfg,
                          lengths=torch.from_numpy(lengths))
        return lg.float().numpy()

    bf16 = dataclasses.replace(jcfg, dtype="bfloat16")
    ref = jax_logits(jcfg)
    assert np.abs(port_logits(CFG) - ref).max() < 1e-4
    jb = jax_logits(bf16)
    pb = port_logits(dataclasses.replace(CFG, dtype="bfloat16"))

    def rms(a, b):
        return float(np.sqrt(((a - b) ** 2).mean()))

    jax_gap, port_gap, between = rms(jb, ref), rms(pb, ref), rms(jb, pb)
    assert 0 < between < 1.5 * max(jax_gap, port_gap)
    assert 0.5 < port_gap / jax_gap < 2.0


def staged(eng, x, zero_shot: bool):
    """The staged chain ``generate_batch`` takes for long prompts: the
    engine's prefill of the prompts, then its stages."""
    t = {k: v.to(eng.device) for k, v in torch_inputs(x).items()}
    logits, state = eng.prefill(x["prompts"], eng.init_state(B))
    with eng.stage_lock:
        if zero_shot:
            glob = torch.zeros((B, C.GLOBAL_TOKENS_SIZE), dtype=torch.int64)
        else:
            glob, state, logits = eng.run_global(state, logits,
                                                 t["glob_keys"])
        sem, lens, _, _ = eng.run_semantic(state, logits, t["sem_keys"],
                                           t["limits"], t["hard_min"],
                                           zero_shot, not zero_shot)
    return glob, sem, lens


@pytest.mark.parametrize("zero_shot", [False, True])
@pytest.mark.parametrize("graphed", [False, True])
def test_lm_program_equals_staged_chain_int8_bf16_state(
        monkeypatch, int8_params, zero_shot, graphed):
    """In the JAX serving layout (int8 weights, bf16 state) the engine's
    ``lm_program``, the module's ``lm_program`` and the staged chain emit
    the same tokens bit for bit; graphed, through ``PrefillGraphs`` and
    ``StageGraphs`` replayed from their buffers, and eager."""
    if graphed:
        monkeypatch.setattr(graphs, "GraphCache", EagerCache)
    eng = E.TtsEngine(int8_params, INT8_CFG, ECFG, device="cpu")
    if graphed:
        eng.graphs = E.StageGraphs(eng.params, INT8_CFG, eng.device)
        eng.prefill_graphs = E.PrefillGraphs(eng.params, INT8_CFG,
                                             eng.device)
    x = program_inputs(zero_shot, seed=9)
    t = torch_inputs(x)
    got = eng.lm_program(x["prompts"], t["glob_keys"], t["sem_keys"],
                         t["limits"], t["hard_min"], zero_shot)
    module = E.lm_program(int8_params, cfg=INT8_CFG,
                          max_steps=ECFG.max_semantic_tokens,
                          zero_shot=zero_shot, decode_block=4, **t)
    assert_same(got, module, zero_shot)
    assert_same(got, staged(eng, x, zero_shot), zero_shot)
    if graphed:
        keys = set(eng.graphs.cache.programs)
        assert (B, "semantic") not in keys
        assert (B, ECFG.max_semantic_tokens, "semantic", zero_shot) in keys
        assert ((B, "global") in keys) != zero_shot
        assert set(eng.prefill_graphs.cache.programs) == {(B, T)}


def test_lm_program_counts_its_chunk_and_steps(params):
    """One prefill chunk; 32 global steps, TAG_1 and the semantic steps
    until the block check finds every slot done."""
    eng = E.TtsEngine(params, CFG, ECFG, device="cpu")
    x = program_inputs(False)
    t = torch_inputs(x)
    _, _, lens = eng.lm_program(x["prompts"], t["glob_keys"],
                                t["sem_keys"], t["limits"], t["hard_min"],
                                False)
    assert eng.counters["prefill_chunks"] == 1
    # the host reads `done` every decode_block (4) steps, and every slot
    # is done by max(LIMITS) = 16
    sem_steps = eng.counters["decode_steps"] - C.GLOBAL_TOKENS_SIZE - 1
    assert sem_steps % ECFG.decode_block == 0
    assert int(lens.max()) <= sem_steps <= max(LIMITS)


def test_lm_program_chunks_a_long_prompt(params):
    """A prompt longer than the largest bucket prefills in chunks of it,
    the state carried: two chunks for the batch, the long row the staged
    chain's tokens, and the short rows the tokens they draw in a batch of
    one chunk (a zero-length second chunk leaves them alone)."""
    eng = E.TtsEngine(params, CFG, ECFG, device="cpu")
    x = program_inputs(False)
    t = torch_inputs(x)
    long = (x["prompts"][0] * T)[:T + T // 2]
    assert ECFG.prefill_buckets[-1] < len(long) <= 2 * T
    one = eng.lm_program(x["prompts"], t["glob_keys"], t["sem_keys"],
                         t["limits"], t["hard_min"], False)
    assert eng.counters["prefill_chunks"] == 1
    x2 = dict(x, prompts=[long] + x["prompts"][1:])
    two = eng.lm_program(x2["prompts"], t["glob_keys"], t["sem_keys"],
                         t["limits"], t["hard_min"], False)
    assert eng.counters["prefill_chunks"] == 3
    for got, want in zip(two, staged(eng, x2, False)):
        assert np.asarray(got).tolist() == np.asarray(want).tolist()
    for got, want in zip(two, one):
        assert np.asarray(got)[1:].tolist() == np.asarray(want)[1:].tolist()


@pytest.mark.parametrize("zero_shot", [False, True])
def test_generate_batch_serves_through_lm_program(monkeypatch, zero_shot):
    """``generate_batch`` serves every batch through
    ``TtsEngine.lm_program``: one whose prompts fit the largest bucket in
    one prefill chunk, one with a longer prompt in two; the short request
    keeps its tokens in both (f32, the goldens model)."""
    gcfg = RwkvConfig(**chip_smoke.GOLDENS_CFG)
    eng = E.TtsEngine(bridge.rwkv7_params(
        chip_smoke.goldens_params(gcfg, 1234), "cpu"), gcfg, ECFG,
        device="cpu")
    calls = []
    real = eng.lm_program

    def spy(prompts, *a):
        calls.append((len(prompts), max(map(len, prompts))))
        return real(prompts, *a)

    monkeypatch.setattr(eng, "lm_program", spy)
    zs = dict(zero_shot=True, ref_global_tokens=list(range(32))) \
        if zero_shot else {}
    short = TtsArgs(text="one chunk", seed=21, max_tokens=8, **zs)
    long = TtsArgs(text="a prompt longer than the largest bucket " * 8,
                   seed=22, max_tokens=8, **zs)
    n_short = len(eng.build_prompt(short)[0])
    assert n_short <= ECFG.prefill_buckets[-1] < len(eng.build_prompt(long)[0])

    n_long = len(eng.build_prompt(long)[0])
    one = eng.generate_batch([short, short])
    assert calls == [(2, n_short)]
    assert eng.counters["prefill_chunks"] == 1
    both = eng.generate_batch([short, long])
    assert calls == [(2, n_short), (2, n_long)]
    chunks = -(-n_long // ECFG.prefill_buckets[-1])
    assert chunks >= 2
    assert eng.counters["prefill_chunks"] == 1 + chunks
    # the short request's tokens do not depend on the chunks it rode
    for r in (one[0], one[1], both[0]):
        assert r.semantic_tokens == one[0].semantic_tokens
        assert r.global_tokens == one[0].global_tokens


def test_warmup_lm_steps_run_lm_program(monkeypatch):
    """The pipeline's warm-up runs each ``lm_*`` label's batch, bucket and
    mode through ``TtsEngine.lm_program`` (the JAX warm-up runs
    ``lm_program``, ``tests/test_codecs.py:279``): every label of the batch
    ladder × the first two buckets × both modes, and nothing else through
    it."""
    lm_cfg = RwkvConfig(**chip_smoke.GOLDENS_CFG)
    gen = torch.Generator().manual_seed(0)
    from rwkv_tts_tpu_torch.models import bicodec, rwkv7

    bc_cfg = BiCodecConfig.tiny()
    pipe = TtsPipeline(
        rwkv7.init_params(lm_cfg, gen, "cpu"), lm_cfg,
        bicodec.init_params(bc_cfg, gen, "cpu"), bc_cfg,
        engine_cfg=EngineConfig(prefill_buckets=(16, 32),
                                max_semantic_tokens=8, batch_size=2),
        device="cpu")
    eng = pipe.engine
    seen = []
    real = eng.lm_program

    def spy(prompts, glob_keys, sem_keys, limits, hard_min, zero_shot):
        seen.append((len(prompts), len(prompts[0]), zero_shot))
        return real(prompts, glob_keys, sem_keys, limits, hard_min,
                    zero_shot)

    monkeypatch.setattr(eng, "lm_program", spy)
    times = pipe.warmup(detok_buckets=(64,))
    labels = {k for k in times if k.startswith("lm_")}
    want = {(Bw, Tw, zs) for Bw in (1, 2) for Tw in (16, 32)
            for zs in (False, True)}
    assert sorted(seen) == sorted(want)
    assert labels == {f"lm_{'zs' if zs else 'normal'}_{Tw}_b{Bw}"
                      for Bw, Tw, zs in want}
