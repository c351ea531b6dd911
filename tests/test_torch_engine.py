"""The port's engine against the JAX engine: exact tokens of
``tests/goldens.json`` (pinned to the JAX engine by test_goldens.py) on the
bridged ``rwkv7.init_params(CFG, PRNGKey(1234))`` weights, for all four
requests; prompt assembly, chunked prefill and the zero-shot minimum."""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch.config import EngineConfig, RwkvConfig, TtsArgs
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


GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "goldens.json")
CFG = RwkvConfig(**chip_smoke.GOLDENS_CFG)
ECFG = EngineConfig(prefill_buckets=(64, 128), max_semantic_tokens=16)
REQUESTS = chip_smoke.goldens_requests(TtsArgs)


@pytest.fixture(scope="module")
def want():
    with open(GOLDEN_PATH) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jax_params():
    jax = pytest.importorskip("jax")
    from rwkv_tts_tpu.config import RwkvConfig as JConfig
    from rwkv_tts_tpu.models import rwkv7 as J

    return J.init_params(JConfig(**chip_smoke.GOLDENS_CFG),
                         jax.random.PRNGKey(1234))


@pytest.fixture(scope="module")
def engine(jax_params):
    return E.TtsEngine(bridge.rwkv7_params(jax_params, device="cpu"), CFG,
                       ECFG, device="cpu")


@pytest.mark.parametrize("name", list(REQUESTS))
def test_golden_tokens(engine, want, name):
    res = engine.generate(REQUESTS[name])
    assert res.global_tokens == want[name]["global"]
    assert res.semantic_tokens == want[name]["semantic"]


@pytest.mark.parametrize("names", [("normal_seed42", "normal_chinese"),
                                   ("zero_shot", "zero_shot_window")])
def test_batched_generation_matches_goldens(engine, want, names):
    """Two requests in one batch (masked prefill of unequal prompts, per-slot
    limits) emit each request's own golden tokens."""
    out = engine.generate_batch([REQUESTS[n] for n in names])
    for name, res in zip(names, out):
        assert res.global_tokens == want[name]["global"], name
        assert res.semantic_tokens == want[name]["semantic"], name


def test_decode_block_does_not_change_tokens(jax_params, want):
    """Checking `done` on the host every step or every 16 steps emits the
    same tokens."""
    eng = E.TtsEngine(bridge.rwkv7_params(jax_params, device="cpu"), CFG,
                      EngineConfig(prefill_buckets=(64, 128),
                                   max_semantic_tokens=16, decode_block=1),
                      device="cpu")
    res = eng.generate(REQUESTS["zero_shot_window"])
    assert res.semantic_tokens == want["zero_shot_window"]["semantic"]


def test_counters_count_prefill_chunks_and_decode_steps(jax_params):
    eng = E.TtsEngine(bridge.rwkv7_params(jax_params, device="cpu"), CFG,
                      ECFG, device="cpu")
    eng.generate(REQUESTS["normal_seed42"])
    # 32 global steps + TAG_1 + 16 semantic steps
    assert eng.counters == {"prefill_chunks": 1, "decode_steps": 49}


def test_chunked_prefill_matches_jax(jax_params):
    """Prompts longer than the largest bucket prefill in chunks with the
    state carried across (the JAX engine's staged path)."""
    from rwkv_tts_tpu.config import EngineConfig as JEngineConfig
    from rwkv_tts_tpu.config import RwkvConfig as JConfig
    from rwkv_tts_tpu.models import rwkv7 as J
    from rwkv_tts_tpu.runtime.engine import TtsEngine as JEngine

    buckets = (16, 32)
    jeng = JEngine(jax_params, JConfig(**chip_smoke.GOLDENS_CFG),
                   JEngineConfig(prefill_buckets=buckets), use_pallas=False)
    eng = E.TtsEngine(bridge.rwkv7_params(jax_params, device="cpu"), CFG,
                      EngineConfig(prefill_buckets=buckets), device="cpu")
    reqs = [TtsArgs(text=" ".join(f"w{i}" for i in range(40))),
            TtsArgs(text="short")]
    prompts = [eng.build_prompt(r)[0] for r in reqs]
    assert len(prompts[0]) > 64        # three chunks of 32
    lj, sj = jeng.prefill(prompts, J.init_state(jeng.cfg, 2))
    lt, st = eng.prefill(prompts, E.rwkv7.init_state(CFG, 2, device="cpu"))
    assert eng.counters["prefill_chunks"] == -(-len(prompts[0]) // 32)
    err = np.abs(lt.numpy() - np.asarray(lj)).max() / np.abs(lj).max()
    assert err < 1e-4
    for k in ("att_x", "ffn_x", "wkv"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("args", [
    TtsArgs(text="hello world"),
    TtsArgs(text="你好，世界！", gender="male", emotion="HAPPY",
            pitch="high_pitch", speed="very_fast", age="child"),
    TtsArgs(text="fix SPCT_48word SPCT_49wɜːd SPCT_50 here"),
    TtsArgs(text="  spaced\ttext  ", emotion="unknown-value"),
    TtsArgs(text="clone", zero_shot=True, ref_global_tokens=[-3, 5, 9999]),
])
def test_build_prompt_matches_jax(engine, args):
    from rwkv_tts_tpu.runtime.engine import TtsEngine as JEngine

    jeng = JEngine.__new__(JEngine)          # prompt assembly needs no model
    from rwkv_tts_tpu.tokenizer import load_tokenizer
    from rwkv_tts_tpu.tokenizer.rwkv_tokenizer import CachedEncoder
    jeng.encoder = CachedEncoder(load_tokenizer(), normalize=False)
    assert engine.build_prompt(args) == jeng.build_prompt(args)


def test_zs_hard_min_matches_jax():
    pytest.importorskip("jax")
    from rwkv_tts_tpu.runtime.engine import zs_hard_min

    for n in range(0, 2000, 7):
        assert E.zs_hard_min(n) == zs_hard_min(n)


def test_chip_smoke_goldens_weights_are_the_jax_init(jax_params):
    """chip_smoke.py rebuilds the goldens weights with numpy on the card
    machine (no JAX there); they must equal the JAX package's init."""
    import jax

    rebuilt = chip_smoke.goldens_params(CFG, 1234)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax_params):
        node = rebuilt
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def test_engine_refuses_params_on_another_device(jax_params):
    params = bridge.rwkv7_params(jax_params, device="cpu")
    params["emb"] = params["emb"].to("meta")
    with pytest.raises(ValueError):
        E.TtsEngine(params, CFG, ECFG, device="cpu")


def test_mixed_modes_in_one_batch_raise(engine):
    with pytest.raises(ValueError):
        engine.generate_batch([REQUESTS["normal_seed42"],
                               REQUESTS["zero_shot"]])


@pytest.mark.cuda
def test_golden_tokens_on_card(cuda_card, want):
    """The goldens requests through the CUDA kernels (as chip_smoke.py runs
    them)."""
    assert chip_smoke.run_goldens("cuda", ".") == want


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
