"""Two repairs of the card's serving paths, on the CPU where they can be
held: admission and the prefill copy host values through
``utils/device.to_card`` (pinned, non-blocking on a card; the same
values), and ``bicodec.DecodeGraphs`` captures only calls of at most
``DECODE_GRAPH_MAX_LATENTS`` latents, decoding larger ones eagerly with the
same bits and counting them. On the CPU ``EagerCache``
(``tests/test_torch_graphs.py``) stands in for the graph cache."""

import time

import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch.config import (BiCodecConfig, EngineConfig,
                                       RwkvConfig, TtsArgs)
from rwkv_tts_tpu_torch.models import bicodec
from rwkv_tts_tpu_torch.runtime import continuous as CT
from rwkv_tts_tpu_torch.runtime import engine as E
from rwkv_tts_tpu_torch.runtime import graphs
from rwkv_tts_tpu_torch.utils import bridge
from rwkv_tts_tpu_torch.utils import device as D

from test_torch_graphs import EagerCache

CFG = RwkvConfig(**chip_smoke.GOLDENS_CFG)
ECFG = EngineConfig(prefill_buckets=(64, 128), max_semantic_tokens=12)
BC_CFG = BiCodecConfig.tiny()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return bridge.rwkv7_params(chip_smoke.goldens_params(CFG, 1234), "cpu")


@pytest.fixture(scope="module")
def bc_params():
    gen = torch.Generator().manual_seed(3)
    return bicodec.init_params(BC_CFG, gen, "cpu")


@pytest.fixture()
def eager_graphs(monkeypatch):
    monkeypatch.setattr(graphs, "GraphCache", EagerCache)


# --------------------------------------------------------------------------
# C1d: host-to-card copies
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.int64, torch.bool, torch.float32])
def test_to_card_keeps_the_values(dtype):
    host = (torch.arange(12).reshape(3, 4) % 3).to(dtype)
    out = D.to_card(host, "cpu")
    assert out.dtype == dtype and torch.equal(out, host)
    assert D.to_card(host[:, 1], torch.device("cpu")).tolist() == \
        host[:, 1].tolist()


@pytest.mark.parametrize("rows,view", [([0, 1, 2], True), ([0, 1], True),
                                       ([2, 0], False), ([1], False)])
def test_take_is_a_view_for_a_prefix(rows, view, monkeypatch):
    """A prefix of the burst (every admission off a mesh) is a view: no
    index goes to the card; other rows are an ``index_select`` whose index
    goes through ``to_card``."""
    sent = []
    monkeypatch.setattr(CT, "to_card",
                        lambda host, dev: sent.append(host) or host.to(dev))
    x = torch.arange(24.0).reshape(2, 3, 4)
    got = CT._take(x, rows, 1)
    assert torch.equal(got, x[:, rows])
    assert (got.data_ptr() == x.data_ptr()) == view
    assert [t.tolist() for t in sent] == ([] if view else [rows])


def test_admission_counts_its_copies_and_keeps_the_tokens(params,
                                                          monkeypatch):
    """A staggered pair through the continuous engine: ``copy_s`` beside
    ``prefill_s`` in its stats, one copy of the slot fields a request
    (each admitted alone), and the static engine's tokens."""
    sent = []
    real = CT.to_card
    monkeypatch.setattr(CT, "to_card",
                        lambda host, dev: sent.append(host) or real(host, dev))
    eng = CT.ContinuousEngine(params, CFG, ECFG, block=4, slots=4,
                              device="cpu")
    reqs = [TtsArgs(text="copies one", seed=5, max_tokens=6),
            TtsArgs(text="copies two, a little longer", seed=6,
                    max_tokens=8)]
    try:
        got = [eng.generate(r, timeout=300.0) for r in reqs]
    finally:
        eng.stop()
    assert eng.stats["admitted"] == 2
    assert 0.0 < eng.stats["copy_s"] and eng.stats["prefill_s"] > 0.0
    # [9, 1] each: the slot, stage, limit, hard_min, zs, 2 + 2 key words
    assert [tuple(t.shape) for t in sent] == [(9, 1), (9, 1)]
    assert [int(t[4, 0]) for t in sent] == [0, 0]
    static = E.TtsEngine(params, CFG, ECFG, device="cpu")
    for r, g in zip(reqs, got):
        want = static.generate(r)
        assert (g.global_tokens, g.semantic_tokens) == \
            (want.global_tokens, want.semantic_tokens)


def test_host_probe_reads_admission_and_restores(params):
    """``chip_smoke.host_probe`` around a request on the CPU: admission's
    wall and CPU seconds, no card copy and no allocator reading; on exit
    the engine's admission and both modules' ``to_card`` are the real
    ones again."""
    eng = CT.ContinuousEngine(params, CFG, ECFG, block=4, slots=4,
                              device="cpu")
    real = (CT.to_card, E.to_card)
    try:
        with chip_smoke.host_probe(torch, eng, "cpu") as probe:
            assert CT.to_card is not real[0] and E.to_card is not real[1]
            eng.generate(TtsArgs(text="probe", seed=3, max_tokens=4),
                         timeout=300.0)
    finally:
        eng.stop()
    assert (CT.to_card, E.to_card) == real and "_admit" not in vars(eng)
    assert probe["admit_wall_s"] > 0.0 and probe["admit_cpu_s"] > 0.0
    assert probe["calls"] == 0 and probe["pin_s"] == probe["to_s"] == 0.0
    assert set(probe["cuda"].values()) == {0}


def test_graphed_prefill_reads_through_to_card(eager_graphs, params,
                                              monkeypatch):
    """``PrefillGraphs.run`` and the eager prefill take each chunk's
    tokens and lengths through ``to_card``, and give the same logits and
    state bit for bit."""
    sent = []
    real = E.to_card
    monkeypatch.setattr(E, "to_card",
                        lambda host, dev: sent.append(host) or real(host, dev))
    eng = E.TtsEngine(params, CFG, ECFG, device="cpu")
    pg = E.PrefillGraphs(eng.params, CFG, eng.device)
    prompts = [[5, 6, 7] * 50, [9] * 70, [1, 2]]    # two chunks
    lg, st = eng.prefill_on(pg, prompts, eng.init_state(3))
    n = len(E.prefill_chunks(prompts, ECFG.prefill_buckets))
    assert n == 2 and len(sent) == 2 * n
    lw, sw = eng.prefill_on(None, prompts, eng.init_state(3))
    assert len(sent) == 4 * n
    assert torch.equal(lg, lw)
    assert all(torch.equal(st[k], sw[k]) for k in sw)


def test_slot_updates_fill_in_place_of_scalar_assignment():
    """``_admit_update`` and ``_idle_slots`` write their constants with
    ``index_fill_`` (a scalar assigned through an index is copied from
    pageable host memory on a card): the same values as the assignments
    they replace."""
    slots = CT.init_slots(6, "cpu")
    gen = torch.Generator().manual_seed(4)
    for k, v in slots.items():
        slots[k] = (torch.randint(0, 5, v.shape, generator=gen) > 2
                    if v.dtype == torch.bool else
                    torch.randint(-3, 90, v.shape, generator=gen))
    before = {k: v.clone() for k, v in slots.items()}
    idx = torch.tensor([4, 1, 3])
    m = len(idx)
    args = [torch.arange(m) + 7, torch.arange(m) + 40, torch.arange(m),
            torch.tensor([True, False, True]),
            torch.arange(2 * m).reshape(m, 2),
            -torch.arange(2 * m).reshape(m, 2)]
    got = CT._admit_update(slots, idx, *args)
    want = {k: v.clone() for k, v in slots.items()}
    zero = torch.zeros_like(args[0])
    for k, v in zip(("stage", "override", "n_glob", "n_step", "limit",
                     "hard_min", "nwin", "zs", "gkey", "skey"),
                    (args[0], zero - 1, zero, zero, args[1], args[2], zero,
                     args[3], args[4], args[5])):
        want[k][idx] = v
    want["win"][idx] = False
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    idled = CT._idle_slots(slots, idx)
    want = {k: v.clone() for k, v in slots.items()}
    want["stage"][idx] = CT.IDLE
    want["limit"][idx] = 0
    assert all(torch.equal(idled[k], want[k]) for k in want)
    # new tensors: the slots handed in are untouched
    assert all(torch.equal(slots[k], before[k]) for k in before)


@pytest.mark.cuda
def test_to_card_on_a_card():
    """On a card the copy does not wait for the stream: with ~0.6 s of
    work queued ahead of it, ``to_card`` returns at once from a pinned
    copy of the host tensor (a write to the host tensor after the call
    does not reach the card), and the values arrive."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    host = torch.arange(1 << 20, dtype=torch.int64)
    want = host.clone()
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)        # ~0.6 s of the stream, queued
    t0 = time.perf_counter()
    out = D.to_card(host, "cuda")
    assert time.perf_counter() - t0 < 0.2
    host.fill_(-1)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), want)


# --------------------------------------------------------------------------
# C1e: the vocoder graphs only the shapes worth their pool
# --------------------------------------------------------------------------

def test_graph_bound_covers_the_streams_and_vocode():
    """B = 1 up to the largest detokenize bucket (``vocode`` decodes one
    request at a time) and every streaming window shape of the published
    codec lie within the bound; B = 8 past 256 latents does not."""
    bound = bicodec.DECODE_GRAPH_MAX_LATENTS
    assert bicodec.DETOKENIZE_BUCKETS[-1] <= bound
    for pair in chip_smoke.stream_window_lengths(BiCodecConfig()).values():
        assert max(pair) <= bound
    assert 8 * 256 <= bound < 8 * 512


def test_decode_graphs_eager_past_the_bound(eager_graphs, bc_params,
                                            monkeypatch):
    """With the bound at 64 latents: (1, 64) and (2, 32) replay programs,
    (1, 96) and (2, 40) decode eagerly (counted, no program captured);
    every output equals ``bicodec.decode`` bit for bit."""
    monkeypatch.setattr(bicodec, "DECODE_GRAPH_MAX_LATENTS", 64)
    dg = bicodec.DecodeGraphs(bc_params, BC_CFG, "cpu")
    rng = np.random.default_rng(9)
    for B, S in ((1, 64), (2, 32), (1, 96), (2, 40), (1, 64)):
        g = rng.integers(0, 4096, (B, 32))
        s = rng.integers(0, 8192, (B, S))
        want = bicodec.decode(bc_params, torch.from_numpy(g),
                              torch.from_numpy(s), BC_CFG)
        assert torch.equal(dg.decode(g, s), want), (B, S)
    assert set(dg.cache.programs) == {(1, 64), (2, 32)}
    assert [p.replays for p in dg.cache.programs.values()] == [2, 1]
    assert dg.eager_calls == 2


def test_detokenize_past_the_bound_matches_eager(eager_graphs, bc_params,
                                                 monkeypatch):
    """``detokenize`` of two requests at once whose bucket passes the bound
    runs eager through the graphs' owner and returns the eager samples."""
    padded = bicodec._detok_bucket(30 + bicodec.receptive_latents(BC_CFG),
                                   bicodec.DETOKENIZE_BUCKETS)
    monkeypatch.setattr(bicodec, "DECODE_GRAPH_MAX_LATENTS", padded)
    dg = bicodec.DecodeGraphs(bc_params, BC_CFG, "cpu")
    rng = np.random.default_rng(11)
    g = rng.integers(0, 4096, (2, 32))
    s = rng.integers(0, 8192, (2, 30))
    got = bicodec.detokenize(bc_params, g, s, BC_CFG, graphs=dg)
    np.testing.assert_array_equal(
        got, bicodec.detokenize(bc_params, g, s, BC_CFG))
    assert dg.eager_calls == 1 and not dg.cache.programs
    got1 = bicodec.detokenize(bc_params, g[:1], s[:1], BC_CFG, graphs=dg)
    np.testing.assert_array_equal(
        got1, bicodec.detokenize(bc_params, g[:1], s[:1], BC_CFG))
    assert dg.eager_calls == 1 and len(dg.cache.programs) == 1
