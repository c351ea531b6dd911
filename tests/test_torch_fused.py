"""The fused layout and the fused decode step of the port against the JAX
package: ``fuse_params`` bit for bit, the fused step's plain version
(``ops.wkv7.wkv7_step_fused``) against the Pallas kernel
``wkv7_step_fused_bt_pallas`` in interpret mode (through a transpose to its
batch-in-lanes layout) and against the unfused chain, f32 and bf16 state,
within 2e-3 (``tests/test_rwkv7.py:240-245``); its in-place wrapper; and
the model's ``step`` with ``STEP_FUSED`` on against the JAX model's
unfused step. On a card only: the kernel against the plain version."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu.config import RwkvConfig as JConfig
from rwkv_tts_tpu.models import rwkv7 as J
from rwkv_tts_tpu.ops.wkv7 import wkv7_step_fused_bt_pallas
from rwkv_tts_tpu_torch.config import BiCodecConfig, EngineConfig, RwkvConfig
from rwkv_tts_tpu_torch.models import rwkv7 as P
from rwkv_tts_tpu_torch.ops import wkv7 as W
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
TOL = 2e-3


def rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def soup_inputs(B, H, N, seed):
    """The fused step's operands at the magnitudes of
    ``tests/test_wkv7.py:327``: eight [B, H, N] seq operands, params8
    [8, H, N] and a state [B, H, N, N], all f32 numpy."""
    rng = np.random.default_rng(seed)
    C = H * N
    f32 = np.float32
    r, k, v, v_first, g = (rng.normal(size=(B, H, N)).astype(f32) * 0.5
                           for _ in range(5))
    lo_w, lo_a, lo_v = (rng.normal(size=(B, H, N)).astype(f32)
                        for _ in range(3))
    params8 = np.stack([
        rng.uniform(0.5, 1.0, C), rng.uniform(0.5, 1.0, C),
        rng.normal(size=C) - 4.0, rng.normal(size=C) * 0.1,
        rng.normal(size=C) * 0.1, rng.normal(size=C) * 0.3,
        rng.uniform(0.8, 1.2, C), rng.normal(size=C) * 0.1,
    ]).astype(f32).reshape(8, H, N)
    state = (rng.normal(size=(B, H, N, N)) * 0.2).astype(f32)
    return (r, lo_w, lo_a, lo_v, k, v, g, v_first), params8, state


def pallas(seq, params8, state, notfirst):
    """``wkv7_step_fused_bt_pallas`` in interpret mode, through its
    [H, N, B] / [H, N, N, B] layout and back."""
    def bt(t):
        return jnp.asarray(np.transpose(t, (1, 2, 0)))

    out, s = wkv7_step_fused_bt_pallas(
        *map(bt, seq), jnp.asarray(np.transpose(state, (1, 2, 3, 0))),
        jnp.asarray(params8), notfirst, gn_eps=64e-5, interpret=True)
    return (np.transpose(np.asarray(out), (2, 0, 1)),
            np.transpose(np.asarray(s, np.float32), (3, 0, 1, 2)))


@pytest.mark.parametrize("notfirst", [1.0, 0.0])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_step_fused_plain_matches_pallas(notfirst, state_dtype):
    """The plain version against the TPU kernel (interpret mode): 2e-3.
    A bf16 state is read rounded on both sides; the kernel rounds its
    output state once more at its store (half a bf16 ulp, up to 2e-3 of
    the largest element), so that state is held to 1e-2, as
    ``test_torch_rwkv7.py`` holds a bf16 state."""
    seq, params8, state = soup_inputs(3, 2, 64, 1)
    jdt = jnp.dtype(state_dtype)
    state = np.array(jnp.asarray(state, jdt).astype(jnp.float32))
    want_out, want_s = pallas(seq, params8,
                              np.asarray(jnp.asarray(state, jdt)), notfirst)
    out, s = W.wkv7_step_fused(*map(torch.from_numpy, seq),
                               torch.from_numpy(state),
                               torch.from_numpy(params8), notfirst)
    assert rel_err(out, want_out) < TOL
    assert rel_err(s, want_s) < (TOL if state_dtype == "float32" else 1e-2)


def test_step_fused_plain_matches_unfused_chain():
    """The plain version against the model's unfused chain: decay, iclr,
    v-gate, key shaping, the decode WKV, group norm, bonus and gate, as
    ``rwkv7.step`` computes them (``tests/test_wkv7.py:327``)."""
    B, H, N = 4, 2, 64
    (r, lo_w, lo_a, lo_v, k, v, g, v_first), params8, state = \
        soup_inputs(B, H, N, 2)
    T = torch.from_numpy
    k_k, k_a, w0, a0, v0, r_k, ln_w, ln_b = T(params8)
    w = -torch.logaddexp(-(w0 + T(lo_w)), torch.zeros(1)) - 0.5
    iclr = torch.sigmoid(a0 + T(lo_a))
    v_eff = T(v) + (T(v_first) - T(v)) * torch.sigmoid(v0 + T(lo_v))
    kk = torch.nn.functional.normalize(T(k) * k_k, dim=-1, eps=0.0)
    k_in = T(k) * (1 + (iclr - 1) * k_a)
    y, s_want = W.wkv7_single(T(r), w, k_in, v_eff, -kk, kk * iclr,
                              T(state))
    yn = P._group_norm(y.reshape(B, H * N), ln_w.reshape(-1),
                       ln_b.reshape(-1), H, 64e-5).reshape(B, H, N)
    rk = (T(r) * k_in * r_k).sum(-1, keepdim=True)
    want = (yn + rk * v_eff) * T(g)
    out, s = W.wkv7_step_fused(*map(T, (r, lo_w, lo_a, lo_v, k, v, g,
                                        v_first)),
                               T(state), T(params8), 1.0)
    assert rel_err(out, want) < TOL
    assert rel_err(s, s_want) < TOL


def test_step_fused_wrapper_updates_one_layer_in_place():
    """The wrapper rewrites only ``state_stack[layer]`` (with the plain
    version's state) and takes row-strided operand views."""
    B, H, N, L = 2, 2, 64, 3
    seq, params8, state = soup_inputs(B, H, N, 3)
    stack = torch.from_numpy(
        np.random.default_rng(4).normal(size=(L, B, H, N, N))
        .astype(np.float32))
    stack[1] = torch.from_numpy(state)
    before = stack.clone()
    # r, k, v as column slices of one [B, 3C] buffer, as the fused
    # projections give them
    rkv = torch.cat([torch.from_numpy(t).reshape(B, -1)
                     for t in (seq[0], seq[4], seq[5])], dim=1)
    C = H * N
    views = [rkv[:, i * C:(i + 1) * C].reshape(B, H, N) for i in range(3)]
    ops = list(map(torch.from_numpy, seq))
    ops[0], ops[4], ops[5] = views
    assert not ops[0].is_contiguous()
    out = W.wkv7_step_fused_(*ops, torch.from_numpy(params8), stack, 1,
                             1.0)
    want_out, want_s = W.wkv7_step_fused(*map(torch.from_numpy, seq),
                                         torch.from_numpy(state),
                                         torch.from_numpy(params8), 1.0)
    assert torch.equal(out, want_out) and torch.equal(stack[1], want_s)
    assert torch.equal(stack[[0, 2]], before[[0, 2]])
    with pytest.raises(ValueError):
        W.wkv7_step_fused_(*ops[:7], ops[7].transpose(1, 2),
                           torch.from_numpy(params8), stack, 1, 1.0)
    with pytest.raises(IndexError):
        W.wkv7_step_fused_(*ops, torch.from_numpy(params8), stack, L, 1.0)


def test_fuse_params_matches_jax():
    """The port's ``fuse_params`` gives the JAX package's fused leaves bit
    for bit (f32 and bf16 weights), and refuses a partial-quant tree."""
    for pdt in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(JCFG, param_dtype=pdt)
        jp = J.init_params(jcfg, jax.random.PRNGKey(5))
        mine = P.fuse_params(bridge.rwkv7_params(jp, device="cpu"), CFG)
        want = bridge.rwkv7_params(J.fuse_params(jp, jcfg), device="cpu")
        assert set(mine["blocks"]) == set(want["blocks"])
        for k, v in want["blocks"].items():
            assert torch.equal(mine["blocks"][k], v), (pdt, k)
    with pytest.raises(ValueError, match="BEFORE quantization"):
        P.fuse_params({"blocks": (mine["blocks"], mine["blocks"])}, CFG)


@pytest.fixture(scope="module")
def fused_trees():
    jp = J.init_params(JCFG, jax.random.PRNGKey(1234))
    jt = J.fuse_params(jp, JCFG)
    return jp, jt, bridge.rwkv7_params(jt, device="cpu")


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_step_fused_model_matches_jax_unfused(fused_trees, monkeypatch,
                                              state_dtype):
    """With STEP_FUSED on, the port's step on the fused tree against the
    JAX model's step on the raw tree (its unfused chain), after the same
    masked prefill: logits and state within 2e-3 (f32 state; 1e-2 for a
    bf16 state, rounded once per step on each side in different orders)."""
    jp, jt, pt = fused_trees
    jcfg = dataclasses.replace(JCFG, state_dtype=state_dtype)
    cfg = dataclasses.replace(CFG, state_dtype=state_dtype)
    tol = 1e-2 if state_dtype == "bfloat16" else TOL
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 77923, (3, 20)).astype(np.int32)
    lens = np.array([20, 13, 1], np.int32)
    _, sj = J.forward(jp, toks, J.init_state(jcfg, 3), jcfg, lengths=lens)
    _, st = P.forward(pt, torch.from_numpy(toks).long(),
                      P.init_state(cfg, 3, device="cpu"), cfg,
                      lengths=torch.from_numpy(lens).long())
    monkeypatch.setattr(P, "STEP_FUSED", True)
    launched = []
    monkeypatch.setattr(P, "wkv7_step_fused_",
                        lambda *a: launched.append(1) or
                        W.wkv7_step_fused_(*a))
    for tok in ([5, 8194, 100], [8196, 0, 12000]):
        tok = np.array(tok, np.int32)
        lj, sj = J.step(jp, tok, sj, jcfg, head_slice=8320)
        lt, st = P.step(pt, torch.from_numpy(tok).long(), st, cfg,
                        head_slice=8320)
        assert rel_err(lt, lj) < tol
        for k in ("att_x", "ffn_x", "wkv"):
            assert rel_err(st[k].float(), sj[k]) < tol, k
    assert len(launched) == 2 * CFG.n_layer


def test_step_fused_off_keeps_the_decode_kernel(fused_trees, monkeypatch):
    """With STEP_FUSED off (the default), the fused tree's step takes the
    unfused chain's decode WKV, as the JAX model does."""
    _, _, pt = fused_trees
    assert P.STEP_FUSED is False
    monkeypatch.setattr(P, "wkv7_step_fused_",
                        lambda *a: pytest.fail("fused step taken"))
    P.step(pt, torch.tensor([1, 2]), P.init_state(CFG, 2, device="cpu"),
           CFG)


def test_chip_smoke_quantized_at_tiny_shapes():
    """chip_smoke.py's quantized phase and its checks on the CPU at the
    goldens LM and the tiny codec (the card run uses full width): int8 and
    int4 through synthesize_batch, fused int8 with both switches through
    the engine, and its step against the plain versions (equal here: the
    CPU takes the plain versions on both sides). The switches come back
    off."""
    out = chip_smoke.quantized(
        torch, CFG, BiCodecConfig.tiny(), "cpu", max_tokens=4,
        engine_cfg=EngineConfig(prefill_buckets=(32, 64),
                                max_semantic_tokens=8), warmup=False)
    for kind in ("int8", "int4"):
        assert len(out[kind]["results"]) == len(chip_smoke.TEXTS)
        assert out[kind]["counters"]["prefill_chunks"] == 1
    fused = out["fused_int8"]
    assert len(fused["results"]) == len(chip_smoke.TEXTS)
    assert fused["step_vs_plain"] == (0.0, 0.0)
    assert P.STEP_FUSED is False
    from rwkv_tts_tpu_torch.ops import quant as Q
    assert Q.USE_QMM_KERNEL is False


# -- on a card --------------------------------------------------------------

@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("B, H", [(3, 2), (8, 32)])
@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_step_fused_kernel_matches_plain(cuda_card, B, H, state_dtype,
                                         in_dtype):
    """The kernel against its plain version on the card, layer 1 of a
    3-layer stack; the other layers untouched. Same operands, f32 math,
    other summation orders: 1e-4 relative (f32 state), 2e-2 (bf16 state,
    rounded once at the store)."""
    seq, params8, state = soup_inputs(B, H, 64, 5)
    dev = "cuda"
    ops = [torch.from_numpy(t).to(dev) for t in seq]
    for i in (0, 4, 5):
        ops[i] = ops[i].to(in_dtype)
    stack = torch.zeros((3, B, H, 64, 64), dtype=state_dtype, device=dev)
    stack[1] = torch.from_numpy(state).to(dev).to(state_dtype)
    before = stack.clone()
    pp = torch.from_numpy(params8).to(dev)
    want_out, want_s = W.wkv7_step_fused(*ops, stack[1].clone(), pp, 1.0)
    W.reset_launches()
    out = W.wkv7_step_fused_(*ops, pp, stack, 1, 1.0)
    torch.cuda.synchronize()
    assert W.LAUNCHES["wkv7_step_fused"] == 1
    tol = 1e-4 if state_dtype == torch.float32 else 2e-2
    assert rel_err(out.cpu(), want_out.cpu()) < 1e-4
    assert rel_err(stack[1].float().cpu(),
                   want_s.to(state_dtype).float().cpu()) < tol
    assert torch.equal(stack[[0, 2]], before[[0, 2]])
