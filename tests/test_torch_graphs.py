"""The engines' decode steps as CUDA graphs (``runtime/graphs.py``).

On the CPU a graph cannot be captured, so ``EagerCache`` stands in for
``graphs.GraphCache``: "capture" warms the body up on a copy of its buffers
as the real cache does, and a "replay" runs the body on the buffers. That
drives the graphed paths' protocol (static buffers, device-side step
counters, inputs copied in place) through both engines, which must emit
``tests/goldens.json`` and the JAX continuous engine's tokens exactly.

A capture-safety mode (``HostReadGuard``) fails on anything that reads a
value back to the host or builds a device tensor from host values; every
captured body runs under it in every weight layout, and a planted
``.item()`` and the NF4 codebook built per call (the hazard the port
repaired) fail it.

On a card (``-m cuda``; skipped here) the graphed block equals the eager
block bit for bit, and the graphed static engine emits the goldens.
"""

import json
import os
import threading

import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from rwkv_tts_tpu_torch.config import EngineConfig, RwkvConfig, TtsArgs
from rwkv_tts_tpu_torch.models import rwkv7
from rwkv_tts_tpu_torch.ops import quant as Q
from rwkv_tts_tpu_torch.runtime import continuous as CT
from rwkv_tts_tpu_torch.runtime import engine as E
from rwkv_tts_tpu_torch.runtime import graphs
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
ECFG = EngineConfig(prefill_buckets=(64, 128), max_semantic_tokens=16)
REQUESTS = chip_smoke.goldens_requests(TtsArgs)
WAIT = 300.0


@pytest.fixture(scope="module")
def want():
    with open(os.path.join(os.path.dirname(__file__), "goldens.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def params():
    return bridge.rwkv7_params(chip_smoke.goldens_params(CFG, 1234), "cpu")


# --------------------------------------------------------------------------
# GraphCache's interface, replayed eagerly on the CPU
# --------------------------------------------------------------------------

class EagerProgram:
    def __init__(self, body, buffers):
        self.body, self.buffers, self.replays = body, buffers, 0

    def replay(self):
        self.body(self.buffers)
        self.replays += 1


class EagerCache:
    """``graphs.GraphCache`` without a card: the warm-up on a copy at first
    use, then every replay runs the body on the buffers."""

    def __init__(self, device):
        self.programs = {}
        self._turn = threading.Lock()

    def exclusive(self):
        """A turn: the lock alone (one stream on the CPU)."""
        return self._turn

    def __contains__(self, key):
        return key in self.programs

    def program(self, key, body, buffers):
        if key not in self.programs:
            body(graphs.clone_tree(buffers))
            self.programs[key] = EagerProgram(body, buffers)
        return self.programs[key]

    def stats(self):
        return {k: {"replays": p.replays} for k, p in self.programs.items()}

    def clear(self):
        self.programs.clear()


@pytest.fixture()
def eager_graphs(monkeypatch):
    """``graphs.GraphCache`` is ``EagerCache``: the engines' graph holders
    work on the CPU."""
    monkeypatch.setattr(graphs, "GraphCache", EagerCache)


def graphed_static(params):
    """A CPU ``TtsEngine`` whose stages run through ``StageGraphs`` (the
    path a card takes)."""
    eng = E.TtsEngine(params, CFG, ECFG, device="cpu")
    eng.graphs = E.StageGraphs(eng.params, CFG, eng.device)
    return eng


def graphed_continuous(params, ecfg, **kw):
    """A CPU ``ContinuousEngine`` whose blocks run through ``BlockGraphs``
    (the path a card takes)."""
    eng = CT.ContinuousEngine(params, CFG, ecfg, device="cpu", **kw)
    eng.graphs = CT.BlockGraphs(eng.params, CFG, eng.state, eng.logits,
                                eng.slots, eng.block)
    return eng


def collect(eng, reqs):
    """Every request of ``reqs`` ({name: args}) through ``eng``; returns
    {name: result}."""
    import threading

    got, done = {}, threading.Event()

    def mk(name):
        def cb(res):
            got[name] = res
            if len(got) == len(reqs):
                done.set()
        return cb

    try:
        for name, r in reqs.items():
            eng.submit(r, mk(name))
        assert done.wait(WAIT), f"only {sorted(got)} finished"
    finally:
        eng.stop()
    for name, res in got.items():
        assert not isinstance(res, Exception), (name, res)
    return got


# --------------------------------------------------------------------------
# (a) the graphed protocol emits the goldens
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(REQUESTS))
def test_static_stage_graphs_emit_goldens(eager_graphs, params, want, name):
    """Each goldens request through the static engine's graphed stages
    (the stage steps replayed from ``StageGraphs``' buffers)."""
    eng = graphed_static(params)
    res = eng.generate(REQUESTS[name])
    assert res.global_tokens == want[name]["global"]
    assert res.semantic_tokens == want[name]["semantic"]
    zs = REQUESTS[name].zero_shot
    keys = set(eng.graphs.cache.programs)
    assert (16, "semantic", zs) in {k[1:] for k in keys if len(k) == 4}
    assert ((1, "global") in keys) != zs


@pytest.mark.parametrize("names", [("normal_seed42", "normal_chinese"),
                                   ("zero_shot", "zero_shot_window")])
def test_static_stage_graphs_batched(eager_graphs, params, want, names):
    """Two requests in one batch, then the same batch again: the second
    call replays the first call's programs from the same buffers."""
    eng = graphed_static(params)
    for _ in range(2):
        out = eng.generate_batch([REQUESTS[n] for n in names])
        for name, res in zip(names, out):
            assert res.global_tokens == want[name]["global"], name
            assert res.semantic_tokens == want[name]["semantic"], name
    # one program per (batch, stage, zero-shot), each captured once
    assert all(p.replays > 0 for p in eng.graphs.cache.programs.values())
    assert len(eng.graphs.cache.programs) == (1 if "zero" in names[0]
                                              else 3)


def test_static_stage_graphs_counters(eager_graphs, params):
    """The graphed stages count decode steps as the eager stages do."""
    eng = graphed_static(params)
    eng.generate(REQUESTS["normal_seed42"])
    assert eng.counters == {"prefill_chunks": 1, "decode_steps": 49}


def test_continuous_block_graphs_emit_goldens(eager_graphs, params, want):
    """The goldens requests through a continuous engine whose blocks run
    through ``BlockGraphs``."""
    eng = graphed_continuous(params, ECFG, block=8, slots=4)
    got = collect(eng, REQUESTS)
    for name in want:
        assert got[name].global_tokens == want[name]["global"], name
        assert got[name].semantic_tokens == want[name]["semantic"], name
    # K step replays a block; the draws once a block and once before the
    # step's capture
    progs = eng.graphs.cache.programs
    assert progs[("step", 4)].replays == 8 * eng.stats["blocks"]
    assert progs[("draws", 4)].replays == eng.stats["blocks"] + 1


@pytest.fixture(scope="module")
def jax_side():
    jax = pytest.importorskip("jax")
    from rwkv_tts_tpu.config import EngineConfig as JE
    from rwkv_tts_tpu.config import RwkvConfig as JC
    from rwkv_tts_tpu.config import TtsArgs as JArgs
    from rwkv_tts_tpu.models import rwkv7 as J
    from rwkv_tts_tpu.runtime import continuous as JCT

    jcfg = JC(**chip_smoke.GOLDENS_CFG)
    jparams = J.init_params(jcfg, jax.random.PRNGKey(1234))
    return JCT, jcfg, JE, jparams, JArgs


@pytest.mark.parametrize("zero_shot", [False, True])
def test_continuous_block_graphs_match_jax_engine(eager_graphs, jax_side,
                                                  zero_shot):
    """Normal or zero-shot requests, more of them than slots and of
    different lengths, through the JAX continuous engine and through the
    port's with its blocks graphed, over 8 slots with occupancy buckets 2
    and 4 (bucketed programs, compaction): the same tokens."""
    JCT, jcfg, JE, jparams, JArgs = jax_side
    ecfg = dict(prefill_buckets=(64, 128), max_semantic_tokens=24,
                batch_size=8)
    texts = ("one", "a longer request text", "三个", "four four",
             "the fifth", "six")
    reqs = {f"r{i}": TtsArgs(text=t, seed=30 + i, max_tokens=6 + 3 * i,
                             zero_shot=zero_shot,
                             ref_global_tokens=[i + 2] * 32 if zero_shot
                             else None)
            for i, t in enumerate(texts)}
    jeng = JCT.ContinuousEngine(jparams, jcfg, JE(**ecfg), use_pallas=False,
                                block=4, slots=8)
    try:
        jgot = collect(jeng, {n: JArgs(**{f: getattr(r, f) for f in
                                          r.__dataclass_fields__})
                              for n, r in reqs.items()})
    finally:
        jeng.stop()
    eng = graphed_continuous(bridge.rwkv7_params(jparams, "cpu"),
                             EngineConfig(**ecfg), block=4, slots=8,
                             buckets=(2, 4))
    got = collect(eng, reqs)
    for name in reqs:
        assert got[name].global_tokens == jgot[name].global_tokens, name
        assert got[name].semantic_tokens == jgot[name].semantic_tokens, name
    assert {k[0] for k in eng.graphs.cache.programs} == {"draws", "step"}


def test_continuous_warmup_captures_every_bucket(eager_graphs, params):
    """``warmup`` leaves a (draws, step) program for every occupancy
    bucket and the whole batch, and an idle engine."""
    eng = graphed_continuous(params, ECFG, block=4, slots=8, buckets=(2, 4))
    try:
        eng.warmup(max_burst=2, prefill_buckets=1)
    finally:
        eng.stop()
    assert set(eng.graphs.cache.programs) == {
        (p, b) for p in ("draws", "step") for b in (2, 4, 8)}
    assert not eng._live and bool((eng.slots["stage"] == CT.IDLE).all())


def test_block_graphs_equal_eager_block(eager_graphs, params):
    """``chip_smoke.graph_block_check`` (the chip phase's check) at the
    goldens shape: the replayed protocol equals ``decode_block``."""
    r = chip_smoke.graph_block_check(torch, params, CFG, "cpu", B=8,
                                     block=12, profile=False)
    assert r["bitwise"], r
    assert r["live_emits"] > 12


# --------------------------------------------------------------------------
# (b) the captured bodies read nothing back and copy nothing from the host
# --------------------------------------------------------------------------

class HostRead(RuntimeError):
    pass


# Tensor methods and torch functions that read device values on the host
# or build device tensors from host values
HOST_METHODS = {"item", "tolist", "__bool__", "__int__", "__float__",
                "__index__", "cpu", "numpy", "nonzero", "masked_select",
                "unique", "unique_consecutive", "argwhere"}
HOST_BUILDERS = {"tensor", "from_numpy"}
# the same at the operator level: what a C++ function syncs on
HOST_OPS = {"_local_scalar_dense", "nonzero", "masked_select", "_unique2",
            "unique_dim", "unique_consecutive", "is_nonzero", "equal"}


class _FunctionGuard(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in HOST_METHODS or name in HOST_BUILDERS or (
                name == "as_tensor" and args
                and not isinstance(args[0], torch.Tensor)):
            raise HostRead(f"{name} in a captured body")
        return func(*args, **kwargs)


class _DispatchGuard(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in HOST_OPS:
            raise HostRead(f"aten.{func.overloadpacket.__name__} in a "
                           f"captured body")
        return func(*args, **(kwargs or {}))


class HostReadGuard:
    """Fails (``HostRead``) on a host read or a host-built tensor inside
    the block: what a CUDA graph's capture refuses or records wrongly."""

    def __enter__(self):
        self._modes = (_FunctionGuard(), _DispatchGuard())
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self._modes):
            m.__exit__(*exc)
        return False


BF16 = RwkvConfig(**{**chip_smoke.GOLDENS_CFG, "dtype": "bfloat16",
                     "param_dtype": "bfloat16"})
LAYOUTS = ("bf16", "int8", "int4", "nf4", "fused", "fused_step")


@pytest.fixture(scope="module")
def layout_params():
    gen = torch.Generator().manual_seed(7)
    base = rwkv7.init_params(BF16, gen, "cpu")
    fused = rwkv7.fuse_params(base, BF16)
    return {"bf16": base,
            "int8": Q.quantize_rwkv_params(base, kind="int8"),
            "int4": Q.quantize_rwkv_params(base, kind="int4"),
            "nf4": Q.quantize_rwkv_params(base, kind="nf4"),
            "fused": Q.quantize_rwkv_params(fused, kind="int8"),
            "fused_step": Q.quantize_rwkv_params(fused, kind="int8")}


def block_bufs(p, B=4, block=4):
    state, logits, slots = chip_smoke.seeded_slots(torch, CT, BF16, B, "cpu",
                                                   11)
    bg = CT.BlockGraphs(p, BF16, state, logits, slots, block)
    return bg, bg._views(B)


def stage_bufs(p, B=2, max_steps=8):
    sg = E.StageGraphs(p, BF16, torch.device("cpu"))
    bufs = sg._buffers(B, max_steps)
    keys = torch.tensor([[0, 5], [0, 9]])[:B]
    bufs["u_g"].copy_(E.threefry.step_uniforms(keys, 32))
    table = E.semantic_table(keys, torch.full((B,), 6), torch.full((B,), 3),
                             max_steps, True)
    for k, v in table.items():
        bufs["table"][k].copy_(v)
    return sg, bufs


def bodies(p):
    """Every body a graph captures, each as a thunk over fresh buffers."""
    bg, bb = block_bufs(p)
    sg, sb = stage_bufs(p)

    def stage(body, *a):
        def run():
            sb["i"].zero_()     # as each stage starts
            body(sb, *a)
        return run

    return {"continuous_draws": lambda: bg._draws_body(bb),
            "continuous_step": lambda: bg._step_body(bb),
            "static_global": stage(sg._global_body),
            "static_tag1": stage(sg._tag1_body),
            "static_semantic": stage(sg._semantic_body, False),
            "static_semantic_zs": stage(sg._semantic_body, True)}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_captured_bodies_read_nothing_back(eager_graphs, monkeypatch,
                                           layout_params, layout):
    """Both engines' captured bodies, in every weight layout (the fused
    layout with and without the fused decode step), run under the guard:
    no host read and no host-built tensor, in three replays each."""
    monkeypatch.setattr(rwkv7, "STEP_FUSED", layout == "fused_step")
    p = layout_params[layout]
    for name, run in bodies(p).items():
        run()           # first use: packs and codebooks are built here
        with HostReadGuard():
            for _ in range(3):
                run()


def test_guard_fails_on_a_planted_item(eager_graphs, monkeypatch,
                                       layout_params):
    """A body that reads a value back fails the guard."""
    real = E._mask_global

    def planted(logits):
        logits.max().item()
        return real(logits)

    p = layout_params["bf16"]
    todo = bodies(p)
    monkeypatch.setattr(CT, "_mask_global", planted)
    monkeypatch.setattr(E, "_mask_global", planted)
    for name in ("continuous_step", "static_global"):
        with pytest.raises(HostRead, match="item|_local_scalar_dense"):
            with HostReadGuard():
                todo[name]()


def test_guard_fails_on_the_per_call_nf4_codebook(eager_graphs, monkeypatch,
                                                  layout_params):
    """The NF4 codebook built from the host tuple on every dequantization
    (the hazard ``quant._nf4_code`` repaired) fails the guard."""
    monkeypatch.setattr(Q, "_nf4_code", lambda device: torch.tensor(
        Q.NF4_CODE, dtype=torch.float32, device=device))
    run = bodies(layout_params["nf4"])["continuous_step"]
    with pytest.raises(HostRead, match="tensor"):
        with HostReadGuard():
            run()


def test_guard_passes_device_built_tensors():
    """Tensors made on the device (``arange``, ``full``) and ``as_tensor``
    of a tensor pass; ``torch.tensor`` of a list does not."""
    with HostReadGuard():
        x = torch.arange(4) + torch.full((4,), 2)
        torch.as_tensor(x, dtype=torch.int64)
    with pytest.raises(HostRead):
        with HostReadGuard():
            torch.tensor([1, 2])


# --------------------------------------------------------------------------
# launch counting through a capture
# --------------------------------------------------------------------------

def test_record_launches_notes_instead_of_counting():
    """Under ``record_launches`` a wrapper's launch is noted, not counted;
    ``add_launches`` adds a replay's launches."""
    from rwkv_tts_tpu_torch.ops import _build
    from rwkv_tts_tpu_torch.ops import wkv7 as W

    W.reset_launches()
    with _build.record_launches() as noted:
        _build.count_launch(W.LAUNCHES, "wkv7_decode")
        _build.count_launch(W.LAUNCHES, "wkv7_decode")
    assert W.LAUNCHES["wkv7_decode"] == 0 and len(noted) == 2
    _build.add_launches([(W.LAUNCHES, "wkv7_decode", 2)] * 3)
    assert W.LAUNCHES["wkv7_decode"] == 6
    _build.count_launch(W.LAUNCHES, "wkv7_decode")
    assert W.LAUNCHES["wkv7_decode"] == 7
    W.reset_launches()


def test_graph_cache_needs_a_card():
    with pytest.raises(ValueError, match="card"):
        graphs.GraphCache("cpu")


# --------------------------------------------------------------------------
# (c) on a card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_graphed_block_equals_eager_block_on_card(cuda_card, quant):
    """One block of 16 steps replayed as graphs against ``decode_block``
    from the same seeded slots, 8 slots, 4 layers × 512: emits, logits,
    state and slot tensors bit for bit, the same counted launches a
    step."""
    cfg = RwkvConfig(n_layer=4, n_embd=512, head_size=64)
    gen = torch.Generator(device="cuda").manual_seed(3)
    p = rwkv7.make_serving_params(cfg, gen, quant=quant, device="cuda")
    r = chip_smoke.graph_block_check(torch, p, cfg, "cuda", B=8, block=16,
                                     profile=False)
    assert r["equal"] == {"emits": True, "logits": True, "state": True,
                          "slots": True}, r
    assert r["launches_per_step"]["eager"] == \
        r["launches_per_step"]["graphed"]


@pytest.mark.cuda
def test_graphed_engines_emit_goldens_on_card(cuda_card, want):
    """The goldens through the static and the continuous engine on the
    card, both replaying their graphs."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for run in (chip_smoke.static_goldens, chip_smoke.continuous_goldens):
        out = run("cuda", root)
        assert out["requests"] == len(want)
        assert out["programs"] and all(out["programs"].values())
