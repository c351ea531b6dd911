"""The port's ``tools/profile_tp.py`` (``rwkv_tts_tpu_torch/tools``) against
the JAX package's tool of the same name, on the CPU through ``main(argv,
device="cpu")``: the JAX tool's ``small`` configuration (read from its
source as text: importing it sets JAX's compilation cache) on a virtual
(1, 2) mesh of the CPU; ``step_tp``'s logits against the plain step's
within ``tests/test_torch_tp.py``'s tolerance (rtol 1e-4 / atol 1e-4); the
psum-only program against x · (tp · 1.000001)^(2L) and against the JAX
tool's ``shard_map`` of ``psums_only`` on two of JAX's virtual devices;
the JAX tool's lines and its exit without enough devices."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rwkv_tts_tpu_torch.models import rwkv7
from rwkv_tts_tpu_torch.parallel import mesh as meshlib
from rwkv_tts_tpu_torch.parallel import tp as tplib
from rwkv_tts_tpu_torch.tools import profile_tp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-4          # tests/test_torch_tp.py's
LINES = ("devices=", " tp=", " batch=", " shape=", " backend=",
         "single-device step        ", "step_tp (model=",
         "collective schedule only  ", " psums)")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_source() -> str:
    with open(os.path.join(ROOT, "tools", "profile_tp.py")) as f:
        return f.read()


def virtual(tp: int = 2):
    return meshlib.make_mesh(tp, model_parallel=tp, devices=["cpu"] * tp)


def test_tool_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_tp.main(["--virtual", "2", "8", "2"])


def test_tool_runs_as_a_module():
    r = subprocess.run([sys.executable, "-m",
                        "rwkv_tts_tpu_torch.tools.profile_tp", "--help"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("usage: profile_tp")


def test_small_config_and_defaults_are_the_jax_tools():
    """The CPU's model is the JAX tool's ``small`` configuration, the
    positional defaults its 2 8 64, and its lines are the ones printed."""
    src = jax_source()
    for frag in LINES + ("n_layer=2, n_embd=256, head_size=64, "
                         "vocab_size=1000,", "padded_vocab_size=1024, "
                         'dtype="float32"', "8320", "1.000001"):
        assert frag in src, frag
    s = profile_tp.SMALL
    assert (s.n_layer, s.n_embd, s.head_size, s.vocab_size,
            s.padded_vocab_size, s.dtype, s.param_dtype) == \
        (2, 256, 64, 1000, 1024, "float32", "float32")
    a = profile_tp._args([])
    assert (a.tp, a.batch, a.steps, a.virtual) == (2, 8, 64, False)
    for var, want in (("TP", "2"), ("B", "8"), ("STEPS", "64")):
        assert f"{var} = int(sys.argv[" in src and \
            f"else {want}" in src.split(f"{var} = int(sys.argv[")[1] \
            .splitlines()[0], var


def test_exits_without_enough_devices():
    """Without ``--virtual`` and with fewer devices than tp: the JAX tool's
    message, then the port's way to a functional run."""
    with pytest.raises(SystemExit) as e:
        profile_tp.main(["2", "8", "2"], device="cpu")
    assert str(e.value).startswith("need >= 2 devices, have 1 (pass "
                                   "--virtual")
    assert 'f"need >= {TP} devices, have {n_dev} "' in jax_source()


def test_prints_the_jax_lines(capsys):
    """The JAX tool's four lines, then the JSON line: each program's wall
    ms a step (the host clock, no device reading), 2L psums, the virtual
    mesh said so, no psum across a link."""
    out = profile_tp.main(["--virtual", "2", "8", "3"], device="cpu")
    text = capsys.readouterr().out
    lines = text.strip().splitlines()
    assert lines[0].startswith("devices=1 tp=2 batch=8 shape=2x256 "
                               "backend=cpu")
    assert lines[1].startswith("single-device step        ")
    assert lines[2].startswith("step_tp (model=2)       ")
    assert lines[3].startswith("collective schedule only  ")
    assert lines[3].endswith(" ms (4 psums)")
    assert json.loads(lines[-1]) == json.loads(json.dumps(out))
    assert (out["virtual"], out["psums_cross_a_link"], out["weights"]) == \
        (True, False, "f32")
    assert out["psums_per_step"] == 2 * out["L"] == 4
    for k in ("single", "step_tp", "psums_only"):
        assert out[k]["wall_ms"] > 0 and out[k]["busy_ms"] is None
    assert out["logits_rel_err"] < RTOL and out["argmax_agree"] == 1.0


def test_step_tp_matches_the_plain_step():
    """At the small configuration on a virtual (1, 2) CPU mesh, ``step_tp``
    from a fresh state against the plain step from a fresh state, token 5
    for a batch of 8 (the tool's inputs): logits and state within
    rtol 1e-4 / atol 1e-4."""
    cfg = profile_tp.SMALL
    gen = torch.Generator().manual_seed(0)
    params = rwkv7.init_params(cfg, gen, "cpu")
    tok = torch.full((8,), 5, dtype=torch.int64)
    want, ref = rwkv7.step(params, tok, rwkv7.init_state(cfg, 8, "cpu"), cfg,
                           head_slice=1024)
    m = virtual(2)
    st = tplib.shard_state_tp(m, rwkv7.init_state(cfg, 8, "cpu"))
    got, st = tplib.step_tp(tplib.shard_params_tp(m, params), tok, st, cfg,
                            m, head_slice=1024)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    for k, v in st.items():
        torch.testing.assert_close(v.gather(), ref[k], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tp", [1, 2])
def test_psum_program_counts_and_scales(tp):
    """Fed zeros (as the tool feeds it) it returns zeros; fed a nonzero x
    at the small depth it returns x · (tp · 1.000001)^(2L) within f32
    rounding, after 2L psums."""
    L = profile_tp.SMALL.n_layer
    counter = {}
    prog = profile_tp.psum_program(virtual(tp), L, counter)
    assert torch.equal(prog(torch.zeros((8, 256))), torch.zeros((8, 256)))
    assert counter["psums"] == 2 * L
    x = torch.randn((8, 256), generator=torch.Generator().manual_seed(3))
    got = prog(x)
    assert counter["psums"] == 4 * L
    want = x.double() * (tp * profile_tp.NUDGE) ** (2 * L)
    torch.testing.assert_close(got.double(), want, rtol=2e-6, atol=0)


def test_psum_program_matches_the_jax_tools():
    """The JAX tool's ``psums_only`` (a scan of two psums a layer over the
    model axis under ``shard_map``, on two of JAX's virtual CPU devices)
    and the port's program on a virtual (1, 2) mesh, fed the same nonzero
    x: within f32 rounding."""
    jax = pytest.importorskip("jax")
    if len(jax.devices()) < 2:
        pytest.skip("needs two JAX devices")
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from rwkv_tts_tpu.parallel import mesh as jmesh

    L = profile_tp.SMALL.n_layer
    x = np.random.default_rng(4).standard_normal((8, 256)).astype(np.float32)

    def psums_only(x):
        def body(x, _):
            x = jax.lax.psum(x * 1.000001, jmesh.MODEL_AXIS)
            x = jax.lax.psum(x * 1.000001, jmesh.MODEL_AXIS)
            return x, None
        x, _ = jax.lax.scan(body, x, None, length=L)
        return x

    m = jmesh.make_mesh(2, model_parallel=2)
    f = jax.jit(jax.shard_map(psums_only, mesh=m, in_specs=P(),
                              out_specs=P(), check_vma=False))
    want = np.asarray(f(jnp.asarray(x)))
    got = profile_tp.psum_program(virtual(2), L)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    for frag in ("def psums_only(x):", "x * 1.000001", "in_specs=P()",
                 "out_specs=P()", "length=cfg.n_layer"):
        assert frag in jax_source(), frag


def test_int8_weights_on_the_cpu():
    """``--weights int8`` quantizes the model as the card's run does
    (``quantize_rwkv_params``); the step and the TP program still run, and
    their logits' distance is reported, not held: an int8 shard quantizes
    its row-parallel products by its own absmax, as the JAX package's
    does."""
    out = profile_tp.main(["--virtual", "--weights", "int8", "2", "2", "1"],
                          device="cpu")
    assert out["weights"] == "int8" and out["L"] == 2
    assert 0 <= out["logits_rel_err"] < 1
    assert out["psums_per_step"] == 4
