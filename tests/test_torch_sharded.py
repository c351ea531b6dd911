"""Data parallelism and the vocab-parallel placement (``parallel/mesh.py``)
on the 8-device virtual CPU mesh, the contracts of tests/test_sharded.py:
the batch and state split over ``data`` and the embedding rows and head
columns over ``model``, through the engine stages' ``step_fn`` hook after
an unsharded prefill (as the continuous engine's data rows run them), emit
the tokens of the JAX package's unsharded program
(on the same seeded parameters through ``utils/bridge.py``) exactly; so
does the continuous engine on a dp 4 × tp 2 mesh and on a dp 8 mesh,
against the static engine. Also the explicit shards themselves: pieces,
reassembly, the psum's fixed order, and the batch split."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tts_tpu_torch.config import EngineConfig, RwkvConfig, TtsArgs
from rwkv_tts_tpu_torch.models import rwkv7
from rwkv_tts_tpu_torch.parallel import mesh as meshlib
from rwkv_tts_tpu_torch.runtime.continuous import ContinuousEngine
from rwkv_tts_tpu_torch.runtime.engine import (TtsEngine, global_stage,
                                               semantic_stage)
from rwkv_tts_tpu_torch.utils import bridge, threefry
from test_torch_tp import cpu_mesh, seeded_params

CFG_KW = dict(n_layer=2, n_embd=128, head_size=64, vocab_size=77923,
              padded_vocab_size=78080, decay_lora=32, a_lora=32, v_lora=16,
              gate_lora=32, dtype="float32", param_dtype="float32")
CFG = RwkvConfig(**CFG_KW)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    np_params = seeded_params(CFG_KW)
    tokens = np.random.default_rng(1).integers(0, 70000, (8, 16))
    lengths = np.array([16, 9, 12, 16, 5, 7, 16, 11])
    seeds = np.stack([np.array([0, s], np.uint32) for s in range(8)])
    return np_params, tokens, lengths, seeds


def run(forward, params, state, keys, step_fn=None):
    """tests/test_sharded.py's ``_run``: prefill, the global stage, the
    semantic stage (12 steps)."""
    logits, state = forward(state)
    glob, state, logits = global_stage(params, state, logits, keys, CFG,
                                       step_fn=step_fn)
    limits = torch.full((8,), 12, dtype=torch.int64)
    sem, lens, _, _ = semantic_stage(params, state, logits, keys, limits,
                                     torch.zeros_like(limits), CFG, 12, False,
                                     step_fn=step_fn)
    return glob.numpy(), sem.numpy(), lens.numpy()


@pytest.fixture(scope="module")
def want(setup):
    """The JAX package's unsharded program on the same inputs."""
    from rwkv_tts_tpu.config import RwkvConfig as JConfig
    from rwkv_tts_tpu.models import rwkv7 as J
    from rwkv_tts_tpu.runtime.engine import global_stage as jglobal
    from rwkv_tts_tpu.runtime.engine import semantic_stage as jsemantic

    np_params, tokens, lengths, seeds = setup
    jcfg = JConfig(**CFG_KW)
    p = jax.tree_util.tree_map(jnp.asarray, np_params)
    keys = jnp.asarray(seeds)
    logits, state = J.forward(p, jnp.asarray(tokens, jnp.int32),
                              J.init_state(jcfg, 8), jcfg,
                              lengths=jnp.asarray(lengths, jnp.int32))
    glob, state, logits = jglobal(p, state, logits, keys, jcfg)
    limits = jnp.full((8,), 12, jnp.int32)
    sem, lens, _ = jsemantic(p, state, logits, keys, limits,
                             jnp.zeros_like(limits), jcfg, 12, False)
    return np.asarray(glob), np.asarray(sem), np.asarray(lens)


@pytest.mark.parametrize("mp", [1, 2], ids=["data_parallel",
                                            "vocab_parallel"])
def test_sharded_matches_unsharded(setup, want, mp):
    """dp 8 (mp = 1) and dp 4 × vocab 2: the JAX package's unsharded
    tokens, and the port's own unsharded ones, exactly."""
    np_params, tokens, lengths, seeds = setup
    params = bridge.rwkv7_params(np_params, device="cpu")
    keys = threefry.as_words(seeds)
    tok_t, len_t = torch.as_tensor(tokens), torch.as_tensor(lengths)
    plain = run(lambda st: rwkv7.forward(params, tok_t, st, CFG,
                                         lengths=len_t),
                params, rwkv7.init_state(CFG, 8, device="cpu"), keys)
    m = cpu_mesh(mp)
    sp = meshlib.shard_params(m, params)

    def prefill_then_split(st):
        # the continuous engine's admission: an unsharded prefill, its
        # state split over the data axis
        logits, st = rwkv7.forward(params, tok_t, st, CFG, lengths=len_t)
        return logits, meshlib.shard_state(m, st)

    got = run(prefill_then_split, sp,
              rwkv7.init_state(CFG, 8, device="cpu"), keys,
              step_fn=meshlib.make_step_fn(CFG, m))
    for a, b, c, name in zip(got, plain, want, ("global", "semantic",
                                                "lens")):
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(a, c, err_msg=f"{name} vs JAX")


@pytest.mark.parametrize("mp,slots", [(2, 4), (1, 8)],
                         ids=["dp4_tp2", "dp8"])
def test_sharded_continuous_token_identical(setup, mp, slots):
    """The continuous engine with its slots split over the data axis (and
    the layer weights over ``model`` at mp 2): admission prefill and the
    one-slot scatter into the rows, the per-row stage machine; the tokens
    of the single-device static engine exactly."""
    params = bridge.rwkv7_params(setup[0], device="cpu")
    ecfg = EngineConfig(prefill_buckets=(32, 64), max_semantic_tokens=20,
                        batch_size=4)
    reqs = [
        TtsArgs(text="sharded continuous one", seed=11, max_tokens=20),
        TtsArgs(text="two", seed=22, max_tokens=20, gender="male"),
        TtsArgs(text="cloned three", seed=33, max_tokens=20, zero_shot=True,
                ref_global_tokens=list(range(32))),
    ]
    static = TtsEngine(params, CFG, ecfg, device="cpu")
    want = [static.generate(r) for r in reqs]
    eng = ContinuousEngine(params, CFG, ecfg, block=8, slots=slots,
                           mesh=cpu_mesh(mp))
    try:
        got = [eng.generate(r, timeout=300.0) for r in reqs]
    finally:
        eng.stop()
    for w, g, r in zip(want, got, reqs):
        assert g.global_tokens == w.global_tokens, r.text
        assert g.semantic_tokens == w.semantic_tokens, r.text
    assert not eng._live and eng.stats["admitted"] == 3


def test_shards_reassemble_and_share():
    m = cpu_mesh(2)
    x = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
    for spec in ((None, "data", None), (None, "data", "model"),
                 ("model", None, None), (None, None, None)):
        s = meshlib.shard(x, spec, m)
        assert torch.equal(s.gather(), x), spec
        assert s.shape == tuple(x.shape) and s.nbytes == x.numel() * 4
    # replicated read-only pieces on one device are one tensor; state
    # copies are not
    s = meshlib.shard(x, (None, None, "model"), m)
    assert s.local(0, 1) is s.local(3, 1)
    c = meshlib.shard(x, (None, "data", None), m, copies=True)
    assert c.local(0, 0) is not c.local(0, 1)
    assert torch.equal(c.local(0, 0), c.local(0, 1))
    # a Sharded laid out so already comes back unchanged
    assert meshlib.shard(s, (None, None, "model"), m) is s
    with pytest.raises(ValueError, match="does not split"):
        meshlib.shard(x, (None, None, "data"), m)
    row = c.row(2)
    assert row.shape == (4, 2, 6) and row.local(0, 1) is c.local(2, 1)


def test_psum_order_and_batch_split():
    """The psum adds in shard order, in f32, whatever the devices; a batch
    splits over the data rows and gathers back."""
    a = torch.tensor([1e8], dtype=torch.float32)
    b = torch.tensor([-1e8], dtype=torch.float32)
    c = torch.tensor([1.0], dtype=torch.float32)
    devs = [torch.device("cpu")] * 3
    out = meshlib.psum([a, b, c], devs)
    assert [float(o) for o in out] == [1.0, 1.0, 1.0]
    assert out[0] is out[2]
    assert float(meshlib.psum([a, c, b], devs)[0]) == 0.0
    half = torch.tensor([1.0], dtype=torch.bfloat16)
    assert meshlib.psum([half, half], devs[:2])[0].dtype == torch.bfloat16
    m = cpu_mesh(2)
    x = torch.arange(8)
    rows = meshlib.split_batch(x, m)
    assert [r.tolist() for r in rows] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert torch.equal(meshlib.gather_batch(rows, m), x)
    with pytest.raises(ValueError, match="does not split over the data"):
        meshlib.split_batch(torch.arange(6), m)


def test_placement_rules():
    """``param_sharding``: the embedding's rows and the head's columns (a
    quantized head's members too) over model, the rest replicated;
    ``state_sharding`` and ``batch_sharding`` split the batch over data."""
    from rwkv_tts_tpu_torch.ops.quant import quantize_rwkv_params

    p = rwkv7.init_params(RwkvConfig(n_layer=1, n_embd=64, vocab_size=100,
                                     padded_vocab_size=128),
                          device="cpu")
    specs = meshlib.param_sharding(cpu_mesh(2), quantize_rwkv_params(p))
    assert specs["emb"] == ("model", None)
    assert specs["head"] == {"q": (None, "model"), "s": (None, "model")}
    assert specs["blocks"]["w_r"] == {"q": (None, None, None),
                                      "s": (None, None, None)}
    assert specs["ln0_w"] == (None,)
    st = rwkv7.init_state(RwkvConfig(n_layer=1, n_embd=64), 4, device="cpu")
    assert meshlib.state_sharding(cpu_mesh(2), st)["wkv"] == \
        (None, "data", None, None, None)
    assert meshlib.batch_sharding(cpu_mesh(2), 2) == ("data", None)
