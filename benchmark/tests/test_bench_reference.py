"""The plain reference agrees with ``rwkv_tts_tpu_torch`` at small sizes on
the CPU: prompt ids, the stages' sampling domains, the LM through prefill and decode in
the bf16 and int8 layouts' arithmetic, the BiCodec decoder whole and in
the stream's windows. (The test imports both; the reference imports
nothing of the program.)"""

from __future__ import annotations

import copy
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness import traffic, weights  # noqa: E402
from harness.cell import load  # noqa: E402
from reference import rwkv7_tts as ref  # noqa: E402

from rwkv_tts_tpu_torch import constants as C  # noqa: E402
from rwkv_tts_tpu_torch.config import (BiCodecConfig, RwkvConfig,  # noqa: E402
                                       TtsArgs)
from rwkv_tts_tpu_torch.models import bicodec, rwkv7  # noqa: E402
from rwkv_tts_tpu_torch.ops.quant import quantize_rwkv_params  # noqa: E402
from rwkv_tts_tpu_torch.runtime.engine import (TtsEngine,  # noqa: E402
                                               _mask_global, _mask_semantic)
from rwkv_tts_tpu_torch.runtime.streaming import StreamingVocoder  # noqa: E402

TINY_LM = dict(n_layer=2, n_embd=128, decay_lora=16, a_lora=16, v_lora=16,
               gate_lora=16)


def _lm(**over):
    cfg = copy.deepcopy(load("bf16.stream").config["lm"])
    cfg.update(TINY_LM, **over)
    return cfg


def _codec():
    return {k: (list(v) if isinstance(v, tuple) else v) for k, v in
            dataclasses.asdict(BiCodecConfig.tiny()).items()}


def test_prompt_ids_match_the_engine():
    cfg = _lm()
    params = weights.lm_tree(cfg, 1, "cpu")
    eng = TtsEngine(params, RwkvConfig(**cfg), device="cpu")
    vocab = ref.Vocab(str(ROOT / "assets/model/vocab_canonical.txt"))
    mix = load("int8.backlog").mix
    for req in traffic.requests(mix, 77, 40):
        args = TtsArgs(text=req["text"], age=req["age"],
                       gender=req["gender"], emotion=req["emotion"],
                       pitch=req["pitch"], speed=req["speed"])
        assert ref.prompt_ids(vocab, req) == eng.build_prompt(args)[0]


def test_stage_domains_match_the_engine():
    z = torch.randn(3, ref.SEMANTIC_SLICE, generator=torch.Generator()
                    .manual_seed(3))
    assert torch.equal(ref.stage_logits(z, "global"), _mask_global(z))
    assert torch.equal(ref.stage_logits(z, "semantic"), _mask_semantic(z))
    assert (ref.GLOBAL_TOP_K, ref.SEMANTIC_TOP_K) == (
        C.GLOBAL_SAMPLING["top_k"], C.SEMANTIC_SAMPLING["top_k"])


def _program_logits(params, cfg: RwkvConfig, prompt, fed):
    """The program's logits: the prompt as one prefill chunk, then one
    decode step a fed token (the engine's order)."""
    state = rwkv7.init_state(cfg, 1, device="cpu")
    lg, state = rwkv7.forward(params, torch.tensor([prompt]), state, cfg)
    out = [lg[0, :ref.SEMANTIC_SLICE]]
    for t in fed:
        lg, state = rwkv7.step(params, torch.tensor([t]), state, cfg,
                               head_slice=ref.SEMANTIC_SLICE)
        out.append(lg[0])
    return torch.stack(out)


@pytest.mark.parametrize("layout", ["bf16", "int8"])
def test_lm_matches_the_program(layout):
    # float32 activations on both sides, so that what is compared is the
    # layout's arithmetic (the int8 layout's quantization and bf16 state)
    cfg = _lm(dtype="float32", param_dtype="float32",
              state_dtype="bfloat16" if layout == "int8" else "float32")
    raw = weights.lm_tree(cfg, 5, "cpu")
    rc = RwkvConfig(**cfg)
    params = quantize_rwkv_params(raw, kind="int8") if layout == "int8" \
        else raw
    prompt = [77823, 77838, 77869, 77845, 77830, 77826, 8195, 300, 9000,
              8193]
    glob = [(37 * i + 5) % 4096 for i in range(32)]
    sem = [100, 8191, 2, 4000]
    fed = [g + ref.GLOBAL_OFFSET for g in glob] + [ref.TAG_1] + sem[:-1]
    want = _program_logits(params, rc, prompt, fed)
    prec = ref.Precision("int8" if layout == "int8" else "bf16",
                         layout == "int8",
                         "bfloat16" if layout == "int8" else "float32")
    lm = ref.LM(raw, cfg, prec, "cpu")
    rows = ref.teacher_forced(lm, [{"prompt": prompt, "globals": glob,
                                    "semantic": sem}], "cpu")
    got = rows[0]["logits"]
    # the logits each token was drawn from: after the prompt and after
    # each global but the last (the globals), after TAG_1 and after each
    # semantic but the last (the semantic tokens)
    idx = list(range(32)) + [33 + i for i in range(len(sem))]
    # f32 on both sides: summation order only. int8: a product input whose
    # quotient x / scale sits within ulps of k + 1/2 rounds the other way
    # when summed in another order (exact elsewhere), and the bf16 state
    # carries that step's difference on (~0.05 here)
    tol = 1e-4 if layout == "bf16" else 0.1
    assert torch.allclose(got, want[idx], atol=tol, rtol=0), \
        float((got - want[idx]).abs().max())


def test_codec_matches_the_program():
    cfg = _codec()
    p = weights.codec_tree(cfg, 3, "cpu")
    bc = BiCodecConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in cfg.items()})
    g = torch.randint(0, 4096, (1, 32), generator=torch.Generator()
                      .manual_seed(1))
    s = torch.randint(0, 8192, (1, 40), generator=torch.Generator()
                      .manual_seed(2))
    want = bicodec.decode(p, g, s, bc)
    got = ref.codec_decode(p, cfg, g, s)
    assert torch.allclose(got, want, atol=1e-5, rtol=0)
    assert ref.receptive(cfg) == bicodec.receptive_latents(bc)
    whole = bicodec.detokenize(p, g[0].tolist(), s[0].tolist(), bc)[0]
    np.testing.assert_allclose(ref.utterance(p, cfg, g[0].tolist(),
                                             s[0].tolist()), whole,
                               atol=1e-5, rtol=0)


def test_streamed_windows_match_the_program():
    cfg = _codec()
    p = weights.codec_tree(cfg, 4, "cpu")
    bc = BiCodecConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in cfg.items()})
    sem = torch.randint(0, 8192, (45,), generator=torch.Generator()
                        .manual_seed(5)).tolist()
    glob = list(range(32))
    sv = StreamingVocoder(p, bc, glob, latency_mode="flash")
    parts = [sv.push(sem[i:i + 7]) for i in range(0, len(sem), 7)]
    parts.append(sv.push([], flush=True))
    want = np.concatenate(parts)
    mix = load("bf16.stream").mix
    got = ref.streamed(p, cfg, glob, sem, *mix["windows"])
    assert (sv.context, sv.chunk, sv.lookahead) == tuple(mix["windows"])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
