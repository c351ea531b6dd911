"""The port's ``TtsEngine`` on quantized and fused weight trees against the
JAX ``TtsEngine`` (``use_pallas=False``) on the same bridged trees: exact
tokens for the four goldens requests, in every layout the JAX package
serves (int8 as deployed, first-layer int8, int4, NF4, fused, fused int8,
and fused with the port's ``STEP_FUSED`` on), but one.

The exception is int8 × ``normal_chinese``. int8 rounds every activation
to a code, a step function of the activation; the port's activations
differ from XLA's by a few ulps (f32 sums in another order), so an
activation whose quotient x / scale lies within that distance of k + ½
gets another code on each side. At this request's last global step one
does (−15.4999895 on the port, −15.500007 in the JAX model): the logits
then differ by ~5e-2 and the sampled semantic tokens part at once.
``test_int8_divergence_is_a_rounding_tie`` pins that mechanism. Over 20
further requests the port matched the JAX engine's int8 tokens on 19, and
the JAX engine's staged and one-program paths agreed on all 20 (they share
XLA's sums)."""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu.config import EngineConfig as JEngineConfig
from rwkv_tts_tpu.config import RwkvConfig as JConfig
from rwkv_tts_tpu.models import rwkv7 as J
from rwkv_tts_tpu.ops import quant as JQ
from rwkv_tts_tpu.runtime.engine import TtsEngine as JEngine
from rwkv_tts_tpu_torch.config import EngineConfig, RwkvConfig, TtsArgs
from rwkv_tts_tpu_torch.models import rwkv7 as P
from rwkv_tts_tpu_torch.ops import quant as Q
from rwkv_tts_tpu_torch.runtime import engine as E
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
JCFG = JConfig(**chip_smoke.GOLDENS_CFG)
BUCKETS = (64, 128)
REQUESTS = chip_smoke.goldens_requests(TtsArgs)
LAYOUTS = ("int8", "partial", "int4", "nf4", "fused", "fused_int8")


@pytest.fixture(scope="module")
def engines():
    """Per layout: (JAX engine, port engine) on one bridged tree, built on
    first use."""
    jp = J.init_params(JCFG, jax.random.PRNGKey(1234))
    made = {}

    def get(layout):
        if layout not in made:
            if layout == "partial":
                jt = JQ.quantize_rwkv_params(jp, quant_layers=1)
            elif layout.startswith("fused"):
                jt = J.fuse_params(jp, JCFG)
                if layout == "fused_int8":
                    jt = JQ.quantize_rwkv_params(jt)
            else:
                jt = JQ.quantize_rwkv_params(jp, kind=layout)
            made[layout] = (
                JEngine(jt, JCFG, JEngineConfig(prefill_buckets=BUCKETS,
                                                max_semantic_tokens=16),
                        use_pallas=False),
                E.TtsEngine(bridge.rwkv7_params(jt, device="cpu"), CFG,
                            EngineConfig(prefill_buckets=BUCKETS,
                                         max_semantic_tokens=16),
                            device="cpu"))
        return made[layout]
    return get


TIE = ("int8", "normal_chinese")


@pytest.mark.parametrize("layout, name", [
    (layout, name) for layout in LAYOUTS for name in REQUESTS
    if (layout, name) != TIE])
def test_engine_tokens_match_jax(engines, layout, name):
    jeng, eng = engines(layout)
    want = jeng.generate(REQUESTS[name])
    got = eng.generate(REQUESTS[name])
    assert got.global_tokens == list(want.global_tokens)
    assert got.semantic_tokens == list(want.semantic_tokens)


@pytest.mark.parametrize("name", ["normal_seed42", "zero_shot_window"])
def test_fused_step_engine_tokens_match_jax(engines, monkeypatch, name):
    """With the port's STEP_FUSED on, the fused tree's decode steps run
    through the fused step's plain version on the CPU and still emit the
    JAX engine's tokens (the JAX engine keeps its unfused chain)."""
    jeng, eng = engines("fused")
    monkeypatch.setattr(P, "STEP_FUSED", True)
    want = jeng.generate(REQUESTS[name])
    got = eng.generate(REQUESTS[name])
    assert got.global_tokens == list(want.global_tokens)
    assert got.semantic_tokens == list(want.semantic_tokens)


def test_int8_divergence_is_a_rounding_tie(engines, monkeypatch):
    """int8 × normal_chinese: the global tokens are exact; along them the
    port's and the JAX model's step logits agree within 1e-4 until the
    step where one of the port's activation quotients lies within 2e-5 of
    a rounding boundary k + ½, and there they part by more than 1e-3."""
    jeng, eng = engines("int8")
    req = REQUESTS["normal_chinese"]
    got, want = eng.generate(req), jeng.generate(req)
    assert got.global_tokens == list(want.global_tokens)
    assert got.semantic_tokens != list(want.semantic_tokens)

    prompt, _ = eng.build_prompt(req)
    toks = np.zeros((1, 64), np.int32)
    toks[0, :len(prompt)] = prompt
    lens = np.array([len(prompt)], np.int32)
    _, sj = J.forward(jeng.params, toks, J.init_state(JCFG, 1), JCFG,
                      lengths=lens)
    _, st = P.forward(eng.params, torch.from_numpy(toks).long(),
                      P.init_state(CFG, 1, device="cpu"), CFG,
                      lengths=torch.from_numpy(lens).long())
    quotients = []
    real = Q._qmatmul_int8

    def recording(x, w):
        xf = x.float()
        sx = xf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) \
            * (1.0 / 127.0)
        quotients.append((xf / sx).flatten())
        return real(x, w)

    monkeypatch.setattr(Q, "_qmatmul_int8", recording)
    parted = None
    for i, tok in enumerate(t + 8196 for t in got.global_tokens):
        quotients.clear()
        lj, sj = J.step(jeng.params, np.array([tok], np.int32), sj, JCFG,
                        head_slice=8320)
        lt, st = P.step(eng.params, torch.tensor([tok]), st, CFG,
                        head_slice=8320)
        err = float(np.abs(lt.numpy() - np.asarray(lj)).max()
                    / np.abs(np.asarray(lj)).max())
        q = torch.cat(quotients)
        tie = float((q - (torch.floor(q) + 0.5)).abs().min())
        if err > 1e-4:
            parted = (i, err, tie)
            break
    assert parted is not None
    step, err, tie = parted
    assert step == len(got.global_tokens) - 1 and err > 1e-3 and tie < 2e-5
