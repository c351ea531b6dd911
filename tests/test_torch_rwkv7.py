"""The port's RWKV-7 against ``rwkv_tts_tpu/models/rwkv7.py`` at the goldens
config (2 layers × 128, f32) on bridged weights: ``forward`` with
``lengths`` and ``step`` with ``head_slice``, logits and state within 1e-4
relative; the weight bridge; and — on a card only — the model on the card
(kernels) against the model on the CPU (plain versions)."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch.config import RwkvConfig
from rwkv_tts_tpu_torch.models import rwkv7 as P
from rwkv_tts_tpu_torch.utils import bridge


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GOLDENS_CFG = chip_smoke.GOLDENS_CFG
CFG = RwkvConfig(**GOLDENS_CFG)


def rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def jax_model():
    jax = pytest.importorskip("jax")
    from rwkv_tts_tpu.config import RwkvConfig as JConfig
    from rwkv_tts_tpu.models import rwkv7 as J

    jcfg = JConfig(**GOLDENS_CFG)
    return J, jcfg, J.init_params(jcfg, jax.random.PRNGKey(1234))


@pytest.fixture(scope="module")
def params(jax_model):
    return bridge.rwkv7_params(jax_model[2], device="cpu")


def prompts(B=3, T=20, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 77923, (B, T)).astype(np.int32)
    lens = np.array([T, 13, 1][:B], np.int32)
    return toks, lens


def test_forward_with_lengths_matches_jax(jax_model, params):
    J, jcfg, jp = jax_model
    toks, lens = prompts()
    lj, sj = J.forward(jp, toks, J.init_state(jcfg, 3), jcfg, lengths=lens)
    lt, st = P.forward(params, torch.from_numpy(toks).long(),
                       P.init_state(CFG, 3, device="cpu"), CFG,
                       lengths=torch.from_numpy(lens).long())
    assert rel_err(lt, lj) < 1e-4
    for k in ("att_x", "ffn_x", "wkv"):
        assert rel_err(st[k], sj[k]) < 1e-4, k


def test_forward_all_positions_matches_jax(jax_model, params):
    J, jcfg, jp = jax_model
    toks, _ = prompts(B=2, T=9, seed=1)
    lj, sj = J.forward(jp, toks, J.init_state(jcfg, 2), jcfg, last_only=False)
    lt, st = P.forward(params, torch.from_numpy(toks).long(),
                       P.init_state(CFG, 2, device="cpu"), CFG,
                       last_only=False)
    assert lt.shape == (2, 9, CFG.padded_vocab_size)
    assert rel_err(lt, lj) < 1e-4
    assert rel_err(st["wkv"], sj["wkv"]) < 1e-4


def test_zero_length_slot_passes_through(params):
    """A slot of length 0 leaves its state exactly as it was."""
    toks, _ = prompts(B=2, T=6, seed=2)
    s0 = P.init_state(CFG, 2, device="cpu")
    s0 = {k: v + 0.01 * torch.randn(v.shape, generator=torch.Generator()
                                    .manual_seed(3)) for k, v in s0.items()}
    _, s1 = P.forward(params, torch.from_numpy(toks).long(), s0, CFG,
                      lengths=torch.tensor([6, 0]))
    for k in s0:
        assert torch.equal(s1[k][:, 1], s0[k][:, 1]), k


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_step_matches_jax(jax_model, params, state_dtype):
    """Three decode steps with head_slice after a masked prefill. A bf16
    state rounds once per step on both sides, in different summation
    orders: tolerance 1e-2 there."""
    J, jcfg, jp = jax_model
    jcfg = dataclasses.replace(jcfg, state_dtype=state_dtype)
    cfg = dataclasses.replace(CFG, state_dtype=state_dtype)
    toks, lens = prompts()
    _, sj = J.forward(jp, toks, J.init_state(jcfg, 3), jcfg, lengths=lens)
    _, st = P.forward(params, torch.from_numpy(toks).long(),
                      P.init_state(cfg, 3, device="cpu"), cfg,
                      lengths=torch.from_numpy(lens).long())
    tol = 1e-2 if state_dtype == "bfloat16" else 1e-4
    for tok in ([5, 8194, 100], [8196, 0, 12000], [1, 2, 3]):
        tok = np.array(tok, np.int32)
        lj, sj = J.step(jp, tok, sj, jcfg, head_slice=8320)
        lt, st = P.step(params, torch.from_numpy(tok).long(), st, cfg,
                        head_slice=8320)
        assert lt.shape == (3, 8320)
        assert rel_err(lt, lj) < tol
        assert st["wkv"].dtype == getattr(torch, state_dtype)
        for k in ("att_x", "ffn_x", "wkv"):
            assert rel_err(st[k].float(), sj[k]) < tol, k


def test_step_updates_state_in_place(params):
    state = P.init_state(CFG, 2, device="cpu")
    wkv = state["wkv"]
    _, out = P.step(params, torch.tensor([3, 4]), state, CFG)
    assert out is state and out["wkv"] is wkv
    assert float(wkv.abs().sum()) > 0


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_bridge_keeps_every_leaf(param_dtype):
    jax = pytest.importorskip("jax")
    from rwkv_tts_tpu.config import RwkvConfig as JConfig
    from rwkv_tts_tpu.models import rwkv7 as J

    jcfg = JConfig(**dict(GOLDENS_CFG, param_dtype=param_dtype))
    jp = J.init_params(jcfg, jax.random.PRNGKey(5))
    pt = bridge.rwkv7_params(jp, device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(
        {k: v for k, v in pt.items()}, is_leaf=torch.is_tensor))
    for path, leaf in flat_j:
        node = pt
        for p in path:
            node = node[p.key]
        want = np.asarray(leaf)
        assert str(node.dtype).endswith(want.dtype.name), path
        got = node.view(torch.uint16).numpy() if node.dtype == torch.bfloat16 \
            else node.numpy()
        np.testing.assert_array_equal(
            got, want.view(np.uint16) if want.dtype.name == "bfloat16"
            else want)


@pytest.mark.parametrize("layout", ["int8", "int4", "nf4", "partial",
                                    "fused"])
def test_bridge_round_trips_quantized_and_fused_layouts(jax_model, layout):
    """Every serving layout crosses leaf for leaf and bit for bit: the int8,
    int4 and NF4 leaves member by member, the partial-quant blocks as a
    tuple of segment dicts, the fused zrkv/za/lora2 leaves."""
    J, jcfg, jp = jax_model
    jax = pytest.importorskip("jax")
    from rwkv_tts_tpu.ops.quant import quantize_rwkv_params

    if layout == "fused":
        tree = J.fuse_params(jp, jcfg)
    elif layout == "partial":
        tree = quantize_rwkv_params(jp, quant_layers=1)
    else:
        tree = quantize_rwkv_params(jp, kind=layout)
    pt = bridge.rwkv7_params(tree, device="cpu")
    assert isinstance(pt["blocks"], tuple) == (layout == "partial")
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    flat_t = jax.tree_util.tree_leaves_with_path(pt)
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, want), (_, got) in zip(flat_j, flat_t):
        want = np.asarray(want)
        assert str(got.dtype).endswith(want.dtype.name), path
        np.testing.assert_array_equal(got.numpy(), want)


def test_init_params_layout_matches_jax(jax_model):
    """Same keys, shapes and dtypes as the JAX package's init_params."""
    jax = pytest.importorskip("jax")
    _, jcfg, jp = jax_model
    pt = P.init_params(CFG, device="cpu")
    lj = {jax.tree_util.keystr(p): v for p, v in
          jax.tree_util.tree_leaves_with_path(jp)}
    lt = {jax.tree_util.keystr(p): v for p, v in
          jax.tree_util.tree_leaves_with_path(pt)}
    assert set(lj) == set(lt)
    for k in lj:
        assert tuple(lt[k].shape) == tuple(lj[k].shape), k
        assert str(lt[k].dtype).endswith(np.asarray(lj[k]).dtype.name), k


@pytest.mark.cuda
def test_model_on_card_matches_cpu(cuda_card):
    """forward and step through the CUDA kernels against the same model on
    the CPU through the plain versions (f32; tolerance 1e-4 relative)."""
    gen = torch.Generator().manual_seed(7)
    cpu = P.init_params(CFG, gen, device="cpu")
    card = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                if isinstance(v, dict) else v.cuda()) for k, v in cpu.items()}
    toks, lens = prompts()
    outs = []
    for p, dev in ((cpu, "cpu"), (card, "cuda")):
        logits, st = P.forward(p, torch.from_numpy(toks).long().to(dev),
                               P.init_state(CFG, 3, device=dev), CFG,
                               lengths=torch.from_numpy(lens).long().to(dev))
        step_logits, st = P.step(p, torch.tensor([5, 8194, 100], device=dev),
                                 st, CFG, head_slice=8320)
        outs.append([logits.cpu(), step_logits.cpu(), st["wkv"].cpu()])
    for a, b in zip(*outs):
        assert rel_err(b, a) < 1e-4


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
