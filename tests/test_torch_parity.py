"""The port's reference-RNG parity engine (``runtime/parity.py``) against
the JAX package's (``use_pallas=False``) on the goldens model (2 layers ×
128) on the CPU: all four fields of the result (global and semantic
tokens, ``prefill_tokens``, ``decode_steps``) exactly, for a normal
request, a zero-shot request that fills the 12-step EOS window (its gate
both blocks an EOS, a second draw that step, and accepts one), and the
zero-shot empty-semantic fallback draw; ``tests/goldens_parity.json``
exactly; a missing seed raises. Then the static engines' ``prefill_tokens``
and ``decode_steps`` against the JAX engine's on the goldens requests, and
chip_smoke.py's ``parity`` phase rehearsed at the goldens shape."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu.config import EngineConfig as JEngineConfig
from rwkv_tts_tpu.config import RwkvConfig as JRwkvConfig
from rwkv_tts_tpu.config import TtsArgs as JArgs
from rwkv_tts_tpu.runtime import parity as JP
from rwkv_tts_tpu.runtime.engine import TtsEngine as JEngine
from rwkv_tts_tpu_torch import constants as C
from rwkv_tts_tpu_torch.config import EngineConfig, RwkvConfig, TtsArgs
from rwkv_tts_tpu_torch.runtime import parity as PP
from rwkv_tts_tpu_torch.runtime.engine import TtsEngine, zs_hard_min
from rwkv_tts_tpu_torch.utils import bridge


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = RwkvConfig(**chip_smoke.GOLDENS_CFG)
ECFG = dict(prefill_buckets=(64, 128), max_semantic_tokens=16)
M64 = (1 << 64) - 1


def numpy_params():
    """``rwkv7.init_params(CFG, PRNGKey(1234))`` as numpy (the goldens
    weights), for editing before both packages take them."""
    return chip_smoke.goldens_params(CFG, 1234)


def eos_boosted(p, c=3.0):
    """Channel 0 of the final norm made a constant 1 (weight 0, bias 1) and
    row 0 of the head zero but for EOS (``c``): EOS's logit gains ``c``.
    With the reference's unnormalized draw the highest-id survivor of the
    top 80 wins most draws, so EOS is drawn whenever it is among them."""
    p = dict(p)
    p["ln_out_w"] = p["ln_out_w"].copy()
    p["ln_out_b"] = p["ln_out_b"].copy()
    p["head"] = p["head"].copy()
    p["ln_out_w"][0], p["ln_out_b"][0] = 0.0, 1.0
    p["head"][0] = 0.0
    p["head"][0, C.TTS_EOS_TOKEN] = c
    return p


def semantic_boosted(p, c=8.0):
    """As ``eos_boosted``, but every semantic id below EOS gains ``c``: the
    prefill row's top 80 lie in the semantic range."""
    p = eos_boosted(p, 0.0)
    p["head"][0, :C.TTS_EOS_TOKEN] = c
    return p


@pytest.fixture(scope="module")
def engines():
    """One engine per package, their parameters and config swapped per
    case (the JAX step compiles once)."""
    jcfg = JRwkvConfig(**chip_smoke.GOLDENS_CFG)
    p = numpy_params()
    jeng = JP.ReferenceRngEngine(JEngine(jax.tree.map(jnp.asarray, p), jcfg,
                                         JEngineConfig(**ECFG),
                                         use_pallas=False))
    peng = PP.ReferenceRngEngine(TtsEngine(bridge.rwkv7_params(p, "cpu"),
                                           CFG, EngineConfig(**ECFG),
                                           device="cpu"))
    return jeng, peng


def both(engines, args, params=None, **ecfg):
    """The two results for ``args`` over ``params`` (numpy; the goldens
    weights when None) under ``EngineConfig(**ECFG | ecfg)``."""
    jeng, peng = engines
    p = numpy_params() if params is None else params
    jeng.engine.params = jax.tree.map(jnp.asarray, p)
    jeng.engine.engine_cfg = JEngineConfig(**{**ECFG, **ecfg})
    peng.engine.params = bridge.rwkv7_params(p, "cpu")
    peng.engine.engine_cfg = EngineConfig(**{**ECFG, **ecfg})
    jargs = JArgs(**{f.name: getattr(args, f.name)
                     for f in dataclasses.fields(args)})
    return peng.generate(args), jeng.generate(jargs)


def fields(res):
    return (res.global_tokens, res.semantic_tokens, res.prefill_tokens,
            res.decode_steps)


def test_goldens_parity_json(engines):
    with open(os.path.join(os.path.dirname(__file__),
                           "goldens_parity.json")) as f:
        want = json.load(f)
    for name, req in chip_smoke.parity_requests(TtsArgs).items():
        mine, theirs = both(engines, req)
        assert {"global": mine.global_tokens,
                "semantic": mine.semantic_tokens} == want[name], name
        assert fields(mine) == fields(theirs), name


def test_parity_requests_are_the_goldens_tests():
    from test_goldens import PARITY_REQUESTS
    mine = chip_smoke.parity_requests(TtsArgs)
    assert list(mine) == list(PARITY_REQUESTS)
    for name, req in PARITY_REQUESTS.items():
        assert dataclasses.asdict(mine[name]) == dataclasses.asdict(req)


@pytest.mark.parametrize("seed", [42, M64, M64 - 1500],
                         ids=["42", "2^64-1", "2^64-1501"])
def test_normal_request(engines, seed):
    """A property request at u64 seeds whose stage offsets (+1000, +2000)
    wrap mod 2⁶⁴."""
    args = TtsArgs(text="parity across packages", seed=seed, max_tokens=12,
                   gender="male", emotion="SAD", pitch="high_pitch")
    mine, theirs = both(engines, args)
    assert fields(mine) == fields(theirs)
    assert len(mine.global_tokens) == C.GLOBAL_TOKENS_SIZE
    assert mine.prefill_tokens == len(
        engines[1].engine.build_prompt(args)[0])
    assert mine.decode_steps == chip_smoke.parity_steps(mine, 12, False)


def test_zero_shot_request_fills_the_eos_window(engines, monkeypatch):
    """With EOS among the top candidates the gate runs both ways: an EOS
    drawn before the 12-step window is full is masked and drawn again (a
    second draw that step), and one drawn over a full window of non-EOS
    tokens ends the request."""
    drawn = []
    draw = PP.sample_logits_reference

    def counting(logits, *a, **kw):
        drawn.append(draw(logits, *a, **kw))
        return drawn[-1]

    monkeypatch.setattr(PP, "sample_logits_reference", counting)
    args = TtsArgs(text="w", seed=11, zero_shot=True,
                   ref_global_tokens=[5] * 32)
    mine, theirs = both(engines, args, eos_boosted(numpy_params()),
                        max_semantic_tokens=48)
    assert fields(mine) == fields(theirs)
    n = len(mine.semantic_tokens)
    hard_min = zs_hard_min(1)
    assert C.ZS_EOS_WINDOW <= n < 48       # the window filled, EOS ended it
    assert drawn[-1] == C.TTS_EOS_TOKEN
    assert len(drawn) > n + 1              # a blocked EOS drew again
    assert C.TTS_EOS_TOKEN in drawn[hard_min:-1]
    assert mine.decode_steps == n == chip_smoke.parity_steps(mine, 48, True)


@pytest.mark.parametrize("head", ["random", "semantic"])
def test_zero_shot_empty_semantic_fallback(engines, head, monkeypatch):
    """The fallback draws once from the prefill logits with only EOS
    masked. The loop itself cannot leave the list empty (before hard_min
    EOS is masked and the semantic mask zeroes every id above it), so the
    loop gets no step (``max_semantic_tokens=0``) and the head decides
    the fallback: the goldens head puts the row's top candidates above
    EOS (the draw is dropped, no semantic token), a semantic-boosted head
    puts them below it (one token)."""
    drawn = []
    draw = PP.sample_logits_reference

    def counting(logits, *a, **kw):
        drawn.append(draw(logits, *a, **kw))
        return drawn[-1]

    monkeypatch.setattr(PP, "sample_logits_reference", counting)
    params = numpy_params() if head == "random" else \
        semantic_boosted(numpy_params())
    args = TtsArgs(text="clone fixture", seed=0, zero_shot=True,
                   ref_global_tokens=list(range(32)))
    mine, theirs = both(engines, args, params, max_semantic_tokens=0)
    assert fields(mine) == fields(theirs)
    assert len(drawn) == 1 and mine.decode_steps == 0
    if head == "random":
        assert drawn[0] > C.TTS_EOS_TOKEN and mine.semantic_tokens == []
    else:
        assert mine.semantic_tokens == drawn == [drawn[0]]
        assert drawn[0] < C.TTS_EOS_TOKEN


def test_padded_head_columns_are_never_drawn(engines):
    """The step's logits have ``padded_vocab_size`` columns; the host row
    is cut to ``vocab_size`` before any draw, so the fallback over the
    whole row cannot pick a padding column even when the head favours
    them."""
    p = eos_boosted(numpy_params(), 0.0)
    p["head"][0, CFG.vocab_size:] = 50.0
    args = TtsArgs(text="clone fixture", seed=0, zero_shot=True,
                   ref_global_tokens=list(range(32)))
    mine, theirs = both(engines, args, p, max_semantic_tokens=0)
    assert fields(mine) == fields(theirs)
    logits, _ = engines[1]._advance(engines[1].engine.params, [1],
                                    _state(engines[1].engine))
    assert logits.shape == (CFG.vocab_size,)


def _state(engine):
    from rwkv_tts_tpu_torch.models import rwkv7
    return rwkv7.init_state(engine.cfg, 1, device=engine.device)


def test_missing_seed_raises(engines):
    with pytest.raises(ValueError, match="seed"):
        engines[1].generate(TtsArgs(text="x", seed=None))


def test_engine_counters_count_the_parity_steps(engines):
    peng = engines[1]
    before = dict(peng.engine.counters)
    res, _ = both(engines, TtsArgs(text="count me", seed=5, max_tokens=4))
    assert peng.engine.counters["decode_steps"] - before["decode_steps"] \
        == res.decode_steps
    assert peng.engine.counters["prefill_chunks"] - \
        before["prefill_chunks"] == 1


# --------------------------------------------------------------------------
# the production engines' result fields
# --------------------------------------------------------------------------

def test_static_engine_fields_match_jax_engine():
    """``prefill_tokens`` (the prompt's length) and ``decode_steps`` (32 +
    semantic tokens in normal mode, the semantic tokens in zero-shot) of
    the port's static engine equal the JAX engine's on the goldens
    requests, one at a time and as a batch."""
    jcfg = JRwkvConfig(**chip_smoke.GOLDENS_CFG)
    p = numpy_params()
    jeng = JEngine(jax.tree.map(jnp.asarray, p), jcfg, JEngineConfig(**ECFG),
                   use_pallas=False)
    peng = TtsEngine(bridge.rwkv7_params(p, "cpu"), CFG, EngineConfig(**ECFG),
                     device="cpu")
    reqs = chip_smoke.goldens_requests(TtsArgs)
    for names in (("normal_seed42", "normal_chinese"),
                  ("zero_shot", "zero_shot_window")):
        mine = peng.generate_batch([reqs[n] for n in names])
        theirs = jeng.generate_batch([
            JArgs(**dataclasses.asdict(reqs[n])) for n in names])
        for n, a, b in zip(names, mine, theirs):
            assert fields(a) == fields(b), n
            assert a.decode_steps == len(a.semantic_tokens) + (
                0 if reqs[n].zero_shot else C.GLOBAL_TOKENS_SIZE)


def test_chip_smoke_parity_phase_at_the_goldens_shape():
    out = chip_smoke.parity(torch, CFG, "cpu",
                            os.path.dirname(chip_smoke.__file__),
                            max_tokens=8, zs_cap=12)
    names = [r["name"] for r in out["runs"]]
    assert names == ["property"] * 2 + ["zero_shot"] * 2
    assert 64 < out["prompt_len"] <= 128
    assert out["counters"]["prefill_chunks"] == 4
    assert out["counters"]["decode_steps"] == sum(r["steps"]
                                                  for r in out["runs"])
    assert out["launches"]["wkv7_decode"] == 0     # the CPU launches none
    assert out["host"]["trie_inputs"] == 13
