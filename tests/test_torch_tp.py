"""The port's tensor parallelism (``parallel/tp.py``) on virtual CPU meshes,
held against the port's unsharded model and against the JAX package's
``parallel/tp.py`` on its 8 virtual CPU devices: the contracts of
tests/test_tp.py (step at mp 2 and 4, the head slice, full generation
through ``forward_tp`` and the stages' hook, int8 inside half the
int8-versus-f32 envelope, the bytes a shard holds), on the same seeded
parameters carried over through ``utils/bridge.py``; ``make_step_fn``'s
identity; ``MeshConfig`` and ``calculate_rtf`` equal to the originals.

Tolerances: the port's ``step_tp`` against its own unsharded step, and
against JAX's ``step_tp`` at the same mp, within rtol 1e-4 / atol 1e-4 of
f32 logits and state (the sums of partials reorder the f32 contractions);
tokens exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tts_tpu_torch import config as PC
from rwkv_tts_tpu_torch.models import rwkv7
from rwkv_tts_tpu_torch.ops.quant import quantize_rwkv_params
from rwkv_tts_tpu_torch.parallel import mesh as meshlib
from rwkv_tts_tpu_torch.parallel import tp
from rwkv_tts_tpu_torch.runtime.engine import global_stage, semantic_stage
from rwkv_tts_tpu_torch.utils import bridge

CFG_KW = dict(n_layer=2, n_embd=256, head_size=64, vocab_size=1000,
              padded_vocab_size=1024, decay_lora=32, a_lora=32, v_lora=16,
              gate_lora=32, dtype="float32", param_dtype="float32")
CFG = PC.RwkvConfig(**CFG_KW)
# the generation tests feed global ids + 8196 back: the full vocabulary
# (a JAX gather clamps an id out of range, torch raises)
CFG_V_KW = dict(CFG_KW, vocab_size=77923, padded_vocab_size=78080)
CFG_V = PC.RwkvConfig(**CFG_V_KW)
RTOL, ATOL = 1e-4, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_params(cfg_kw, seed=0):
    """The JAX package's ``init_params`` as numpy, with the LoRA first
    stages and the token-shift mixes (zero at init) drawn from a numpy
    seed, so every sharded leaf carries signal."""
    from rwkv_tts_tpu.config import RwkvConfig as JConfig
    from rwkv_tts_tpu.models import rwkv7 as J

    p = jax.tree_util.tree_map(
        np.asarray, J.init_params(JConfig(**cfg_kw), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    b = p["blocks"]
    for k in ("w1", "a1", "v1", "g1"):
        b[k] = (0.1 * rng.standard_normal(b[k].shape)).astype(np.float32)
    for k in ("x_r", "x_w", "x_k", "x_v", "x_a", "x_g", "ffn_x_k"):
        b[k] = rng.uniform(0, 1, b[k].shape).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def setup():
    p = seeded_params(CFG_KW)
    tokens = np.random.default_rng(1).integers(0, 1000, (4, 8))
    return p, tokens


@pytest.fixture(scope="module")
def jax_case():
    """tests/test_tp.py's own inputs: ``init_params(CFG, PRNGKey(0))`` and
    its tokens from ``PRNGKey(1)``, as numpy."""
    from rwkv_tts_tpu.config import RwkvConfig as JConfig
    from rwkv_tts_tpu.models import rwkv7 as J

    p = jax.tree_util.tree_map(
        np.asarray, J.init_params(JConfig(**CFG_KW), jax.random.PRNGKey(0)))
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (4, 8), 0,
                                           1000))
    return p, tokens


def cpu_mesh(mp, n=8):
    return meshlib.make_mesh(n, model_parallel=mp, devices=["cpu"] * n)


def reference(params, tokens):
    """The unsharded step over ``tokens`` [S, B]: (logits per step,
    state)."""
    state = rwkv7.init_state(CFG, tokens.shape[1], device="cpu")
    outs = []
    for t in tokens:
        logits, state = rwkv7.step(params, torch.as_tensor(t), state, CFG)
        outs.append(logits.numpy().copy())
    return outs, state


def jax_step_tp(np_params, tokens, mp):
    """JAX's ``step_tp`` over ``tokens`` on its (8 / mp, mp) mesh."""
    from rwkv_tts_tpu.config import RwkvConfig as JConfig
    from rwkv_tts_tpu.models import rwkv7 as J
    from rwkv_tts_tpu.parallel import mesh as jmesh
    from rwkv_tts_tpu.parallel import tp as jtp

    jcfg = JConfig(**CFG_KW)
    m = jmesh.make_mesh(8, model_parallel=mp)
    sp = jtp.shard_params_tp(m, jax.tree_util.tree_map(jnp.asarray,
                                                       np_params))
    state = jtp.shard_state_tp(m, J.init_state(jcfg, tokens.shape[1]))
    outs = []
    for t in tokens:
        logits, state = jtp.step_tp(sp, jnp.asarray(t, jnp.int32), state,
                                    jcfg, m)
        outs.append(np.asarray(logits))
    return outs, {k: np.asarray(v) for k, v in state.items()}


@pytest.mark.parametrize("mp", [2, 4])
def test_step_tp_matches_unsharded(setup, mp):
    np_params, tokens = setup
    params = bridge.rwkv7_params(np_params, device="cpu")
    want, want_state = reference(params, tokens)
    m = cpu_mesh(mp)
    sp = tp.shard_params_tp(m, params)
    state = tp.shard_state_tp(m, rwkv7.init_state(CFG, tokens.shape[1],
                                                  device="cpu"))
    for i, t in enumerate(tokens):
        logits, state = tp.step_tp(sp, torch.as_tensor(t), state, CFG, m)
        got = logits.numpy()
        np.testing.assert_allclose(got, want[i], rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {i}")
        np.testing.assert_array_equal(got.argmax(-1), want[i].argmax(-1))
    for k in ("att_x", "ffn_x", "wkv"):
        np.testing.assert_allclose(state[k].gather().numpy(),
                                   want_state[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("mp", [2, 4])
def test_step_tp_matches_jax_step_tp(setup, mp):
    """The port's TP step against the JAX package's at the same mesh shape
    (f32; rtol 1e-4, atol 1e-4)."""
    np_params, tokens = setup
    want, want_state = jax_step_tp(np_params, tokens, mp)
    m = cpu_mesh(mp)
    sp = tp.shard_params_tp(m, bridge.rwkv7_params(np_params, device="cpu"))
    state = tp.shard_state_tp(m, rwkv7.init_state(CFG, tokens.shape[1],
                                                  device="cpu"))
    for i, t in enumerate(tokens):
        logits, state = tp.step_tp(sp, torch.as_tensor(t), state, CFG, m)
        np.testing.assert_allclose(logits.numpy(), want[i], rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {i}")
    for k in ("att_x", "ffn_x", "wkv"):
        np.testing.assert_allclose(state[k].gather().numpy(), want_state[k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_step_tp_head_slice(setup):
    np_params, tokens = setup
    m = cpu_mesh(2)
    sp = tp.shard_params_tp(m, bridge.rwkv7_params(np_params, device="cpu"))
    state = tp.shard_state_tp(m, rwkv7.init_state(CFG, tokens.shape[1],
                                                  device="cpu"))
    before = {k: v.clone() for k, v in state.items()}
    logits, _ = tp.step_tp(sp, torch.as_tensor(tokens[0]), before, CFG, m,
                           head_slice=512)
    assert logits.shape == (tokens.shape[1], 512)
    full, _ = tp.step_tp(sp, torch.as_tensor(tokens[0]), state, CFG, m)
    np.testing.assert_allclose(logits.numpy(), full.numpy()[:, :512],
                               rtol=1e-5)


def generation(prefill, stage_params, state, step_fn=None, cfg=CFG_V):
    """Prefill, the 32-token global stage and the semantic stage with
    TAG_1 fed first, as tests/test_tp.py runs them."""
    from rwkv_tts_tpu_torch.utils import threefry

    B = 8
    keys = threefry.as_words(np.stack([np.array([0, s], np.uint32)
                                       for s in range(B)]))
    limits = torch.full((B,), 10, dtype=torch.int64)
    hard_min = torch.zeros((B,), dtype=torch.int64)
    logits, state = prefill(state)
    glob, state, lg = global_stage(stage_params, state, logits, keys, cfg,
                                   step_fn=step_fn)
    sem, lens, _, _ = semantic_stage(stage_params, state, lg, keys, limits,
                                     hard_min, cfg, 10, False,
                                     feed_tag1=True, step_fn=step_fn)
    return glob.numpy(), sem.numpy(), lens.numpy()


def jax_generation(np_params, tokens, lengths):
    """tests/test_tp.py's full generation through JAX's TP path."""
    from rwkv_tts_tpu.config import RwkvConfig as JConfig
    from rwkv_tts_tpu.models import rwkv7 as J
    from rwkv_tts_tpu.parallel import mesh as jmesh
    from rwkv_tts_tpu.parallel import tp as jtp
    from rwkv_tts_tpu.runtime.engine import global_stage as jglobal
    from rwkv_tts_tpu.runtime.engine import semantic_stage as jsemantic

    jcfg = JConfig(**CFG_V_KW)
    B = 8
    m = jmesh.make_mesh(8, model_parallel=2)
    sp = jtp.shard_params_tp(m, jax.tree_util.tree_map(jnp.asarray,
                                                       np_params))
    keys = jnp.asarray(np.stack([np.array([0, s], np.uint32)
                                 for s in range(B)]))
    step_fn = jtp.make_step_fn(jcfg, m)
    state = jtp.shard_state_tp(m, J.init_state(jcfg, B))
    logits, state = jtp.forward_tp(
        sp, jax.device_put(jnp.asarray(tokens, jnp.int32),
                           jmesh.batch_sharding(m, 2)), state, jcfg, m,
        lengths=jax.device_put(jnp.asarray(lengths, jnp.int32),
                               jmesh.batch_sharding(m, 1)))
    glob, state, lg = jglobal(sp, state, logits, keys, jcfg, step_fn=step_fn)
    sem, lens, _ = jsemantic(sp, state, lg, keys,
                             jnp.full((B,), 10, jnp.int32),
                             jnp.zeros((B,), jnp.int32), jcfg, 10, False,
                             feed_tag1=True, step_fn=step_fn)
    return np.asarray(glob), np.asarray(sem), np.asarray(lens)


def test_tp_full_generation_token_identical():
    """Masked variable-length prefill (``forward_tp``) → the global stage →
    the semantic stage with TAG_1 first, through the stages' ``step_fn``
    hook: the unsharded engine stages' tokens, and the JAX package's TP
    tokens, exactly."""
    np_params = seeded_params(CFG_V_KW)
    params = bridge.rwkv7_params(np_params, device="cpu")
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 1000, (8, 16))
    lengths = np.array([16, 9, 12, 16, 5, 7, 16, 11])
    tok_t, len_t = torch.as_tensor(tokens), torch.as_tensor(lengths)

    want = generation(lambda st: rwkv7.forward(params, tok_t, st, CFG_V,
                                               lengths=len_t), params,
                      rwkv7.init_state(CFG_V, 8, device="cpu"))
    m = cpu_mesh(2)
    sp = tp.shard_params_tp(m, params)
    got = generation(
        lambda st: tp.forward_tp(sp, tok_t, st, CFG_V, m, lengths=len_t), sp,
        tp.shard_state_tp(m, rwkv7.init_state(CFG_V, 8, device="cpu")),
        step_fn=tp.make_step_fn(CFG_V, m))
    theirs = jax_generation(np_params, tokens, lengths)
    for a, b, c, name in zip(got, want, theirs, ("global", "semantic",
                                                 "lens")):
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(a, c, err_msg=f"{name} vs JAX")


def test_forward_tp_state_and_logits(setup):
    """``forward_tp`` against ``rwkv7.forward`` on a nonzero state, with and
    without lengths, ``last_only`` off too: the same logits and state
    within the f32 tolerance."""
    np_params, tokens = setup
    params = bridge.rwkv7_params(np_params, device="cpu")
    _, state0 = reference(params, tokens[:2])
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 1000,
                                                             (8, 12)))
    m = cpu_mesh(4)
    sp = tp.shard_params_tp(m, params)
    for lengths, last_only in ((None, True), (torch.tensor(
            [12, 3, 0, 7, 12, 1, 5, 9]), True), (None, False)):
        want, wst = rwkv7.forward(params, toks, state0, CFG,
                                  last_only=last_only, lengths=lengths)
        got, gst = tp.forward_tp(sp, toks, tp.shard_state_tp(m, state0), CFG,
                                 m, last_only=last_only, lengths=lengths)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)
        for k in wst:
            np.testing.assert_allclose(gst[k].gather().numpy(),
                                       wst[k].numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def test_step_tp_int8_matches_unsharded_int8(jax_case):
    """int8 shards too: q like its float tensor, the scales by orientation.
    The row-parallel activation quantization takes the local row absmax,
    so on tests/test_tp.py's inputs the step stays inside half the
    int8-versus-f32 envelope, with the argmax agreeing on at least 75% of
    the rows. (The envelope is a property of those inputs: on other draws
    the JAX package's own int8 TP step leaves it, and the port's follows
    it there within 1e-5, ``test_step_tp_int8_matches_jax``.)"""
    np_params, tokens = jax_case
    params = bridge.rwkv7_params(np_params, device="cpu")
    qp = quantize_rwkv_params(params, kind="int8")
    want, _ = reference(qp, tokens[:1])
    f32_want, _ = reference(params, tokens[:1])
    noise_floor = np.abs(want[0] - f32_want[0]).max()

    m = cpu_mesh(2)
    sp = tp.shard_params_tp(m, qp)
    state = tp.shard_state_tp(m, rwkv7.init_state(CFG, tokens.shape[1],
                                                  device="cpu"))
    logits, _ = tp.step_tp(sp, torch.as_tensor(tokens[0]), state, CFG, m)
    got = logits.numpy()
    dev = np.abs(got - want[0]).max()
    assert dev < 0.5 * noise_floor, (dev, noise_floor)
    assert (got.argmax(-1) == want[0].argmax(-1)).mean() >= 0.75


def test_step_tp_int8_matches_jax(setup):
    """The port's int8 TP step against the JAX package's on the seeded
    parameters (rtol 1e-4, atol 1e-4): the same local-absmax
    quantization of the row-parallel activations."""
    from rwkv_tts_tpu.config import RwkvConfig as JConfig
    from rwkv_tts_tpu.models import rwkv7 as J
    from rwkv_tts_tpu.ops.quant import quantize_rwkv_params as jquant
    from rwkv_tts_tpu.parallel import mesh as jmesh
    from rwkv_tts_tpu.parallel import tp as jtp

    np_params, tokens = setup
    jcfg = JConfig(**CFG_KW)
    jm = jmesh.make_mesh(8, model_parallel=2)
    jsp = jtp.shard_params_tp(jm, jquant(jax.tree_util.tree_map(
        jnp.asarray, np_params), kind="int8"))
    want, _ = jtp.step_tp(jsp, jnp.asarray(tokens[0], jnp.int32),
                          jtp.shard_state_tp(jm, J.init_state(jcfg, 8)),
                          jcfg, jm)
    m = cpu_mesh(2)
    sp = tp.shard_params_tp(m, quantize_rwkv_params(
        bridge.rwkv7_params(np_params, device="cpu"), kind="int8"))
    got, _ = tp.step_tp(sp, torch.as_tensor(tokens[0]), tp.shard_state_tp(
        m, rwkv7.init_state(CFG, 8, device="cpu")), CFG, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_tp_weight_bytes_per_device_shrink(setup):
    """Each model shard holds 1/tp of the six big layer matrices and of
    the head; an int8 leaf's codes shard the same way."""
    np_params, _ = setup
    params = bridge.rwkv7_params(np_params, device="cpu")
    m = cpu_mesh(4)
    for tree in (params, quantize_rwkv_params(params, kind="int8")):
        sp = tp.shard_params_tp(m, tree)

        def shard_bytes(x):
            return int(np.prod(x.shard_shape)) * x.grid[0][0].element_size()

        for name in ("w_r", "w_k", "w_v", "w_o", "ffn_k", "ffn_v"):
            x = sp["blocks"][name]
            x = x["q"] if isinstance(x, dict) else x
            assert shard_bytes(x) * 4 == x.nbytes, name
        head = sp["head"]["q"] if isinstance(sp["head"], dict) \
            else sp["head"]
        assert shard_bytes(head) * 4 == head.nbytes
    # the pieces are the unsharded tensor's, reassembled exactly
    sp = tp.shard_params_tp(m, params)
    assert torch.equal(sp["blocks"]["w_o"].gather(), params["blocks"]["w_o"])
    assert torch.equal(sp["head"].gather(), params["head"])


def test_specs_match_jax(setup):
    """``tp_param_specs`` gives every leaf of the raw and the int8 tree the
    JAX package's partition spec; ``shard_params_tp`` refuses the 4-bit
    layouts with its message."""
    from rwkv_tts_tpu.ops.quant import quantize_rwkv_params as jquant
    from rwkv_tts_tpu.parallel import tp as jtp

    np_params, _ = setup
    params = bridge.rwkv7_params(np_params, device="cpu")
    for kind in (None, "int8"):
        jp = jax.tree_util.tree_map(jnp.asarray, np_params)
        pp = params
        if kind:
            jp, pp = jquant(jp, kind=kind), quantize_rwkv_params(pp,
                                                                 kind=kind)
        got = tp.tp_param_specs(pp)
        flat = jax.tree_util.tree_leaves_with_path(
            jtp.tp_param_specs(jp),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert len(flat) == len(jax.tree_util.tree_leaves(jp))
        for path, spec in flat:
            node, leaf = got, pp
            for k in path:
                node, leaf = node[k.key], leaf[k.key]
            # a JAX spec may leave trailing dims out: they are replicated
            assert tuple(spec) + (None,) * (leaf.ndim - len(spec)) == node, \
                path
    m = cpu_mesh(2)
    for kind in ("int4", "nf4"):
        with pytest.raises(ValueError, match="not TP-shardable"):
            tp.shard_params_tp(m, quantize_rwkv_params(params, kind=kind))


def test_make_step_fn_is_stable():
    """The same (cfg, mesh) gives the same hook object; another mesh or
    config another."""
    a = tp.make_step_fn(CFG, cpu_mesh(2))
    assert tp.make_step_fn(CFG, cpu_mesh(2)) is a
    assert tp.make_step_fn(CFG, cpu_mesh(4)) is not a
    assert tp.make_step_fn(dataclasses.replace(CFG, ln_eps=1e-6),
                           cpu_mesh(2)) is not a
    assert meshlib.make_step_fn(CFG, cpu_mesh(2)) is \
        meshlib.make_step_fn(CFG, cpu_mesh(2))


def test_mesh_config_and_calculate_rtf_match_jax():
    from rwkv_tts_tpu import config as J
    from rwkv_tts_tpu.utils import rtf as jrtf
    from rwkv_tts_tpu_torch.utils import rtf

    assert dataclasses.asdict(PC.MeshConfig()) == \
        dataclasses.asdict(J.MeshConfig())
    assert [f.name for f in dataclasses.fields(PC.MeshConfig)] == \
        [f.name for f in dataclasses.fields(J.MeshConfig)]
    for args in ((16000, 0.5), (0, 1.0), (8000, 2.0, 8000), (1, 0.0)):
        assert rtf.calculate_rtf(*args) == jrtf.calculate_rtf(*args)


def test_make_mesh_layout_and_refusals(monkeypatch):
    m = cpu_mesh(2)
    assert m.shape == {"data": 4, "model": 2} and m.home.type == "cpu"
    assert m.row(3).shape == {"data": 1, "model": 2}
    assert cpu_mesh(2) == m and hash(cpu_mesh(2)) == hash(m)
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        cpu_mesh(3, n=8)
    # no explicit devices means every card, and raises without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        meshlib.make_mesh()
    # the one CPU; a virtual mesh names its devices
    assert meshlib.visible_devices("cpu") == [torch.device("cpu")]
