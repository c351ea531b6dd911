"""The port's vocoder tools (``rwkv_tts_tpu_torch/tools``: ``profile_vocoder``,
``profile_vocoder_batch``, ``profile_vocoder_gemm``) against the JAX
package's tools of the same names (``tools/*.py``), on the CPU at toy sizes
through ``main(argv, device="cpu")``: each prints the JAX tool's lines,
found here in the JAX tool's source (read as text: importing a JAX tool
sets JAX's compilation cache). The decode subsets are held against the JAX
``decode`` under the JAX tool's dispatch (``conv1d_mxu`` in interpret
mode), the shifted-sum product against the JAX package's ``_conv1d`` on
the same bf16-rounded operands, the sub-batch sweep against one call.
``chip_smoke.py``'s ``vocoder_tools`` phase runs here at toy depth.

Tolerances: a subset decode lies nearer JAX's run under the same subset
than the subset moves JAX from its native run (RMS; the bf16 kernel makes
the random-init wave generator chaotic, ``test_torch_bicodec.py``'s
``test_decode_policies_match_jax``); where a subset routes no conv the two
packages' native decodes agree within that file's f32 chain tolerance;
``gemm_conv`` within 1e-5 of the output's largest value; sub-batches
within 1e-5 of one call."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch.config import BiCodecConfig
from rwkv_tts_tpu_torch.models import bicodec as P
from rwkv_tts_tpu_torch.ops import conv1d as C1
from rwkv_tts_tpu_torch.tools import (profile_vocoder, profile_vocoder_batch,
                                      profile_vocoder_gemm)
from rwkv_tts_tpu_torch.utils import bridge

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {"profile_vocoder": profile_vocoder,
         "profile_vocoder_batch": profile_vocoder_batch,
         "profile_vocoder_gemm": profile_vocoder_gemm}
TOY = ["--tiny-codec", "--batch", "2", "--latents", "24", "--iters", "1"]
# chip_smoke's vocoder_tools phase at toy depth
TOY_ARGV = {
    "shapes": ["shapes", "--batch", "1", "--t-div", "512", "--iters", "1"],
    "decode": ["decode", "all", "k1", "wide", "narrow", "native"] + TOY,
    "impl": ["impl", "native", "mxu", "mxu_fused"] + TOY,
    "batch": ["--tiny-codec", "--batch", "4", "--latents", "24", "--subs",
              "1", "2", "4", "--iters", "1"],
    "gemm": TOY}
REFUSE_ARGV = {"profile_vocoder": ["shapes", "--t-div", "512", "--iters",
                                   "1"],
               "profile_vocoder_batch": TOY_ARGV["batch"],
               "profile_vocoder_gemm": TOY}
# the JAX tools' printed lines
VOCODER_LINES = (": native ", " GF/ms) | mxu ", " GF/ms)", "decode[",
                 "decode[conv_impl=")
BATCH_LINES = ("voc_b=", " s for ", " xRT vocoder-only)", ": FAILED (",
               "best: voc_b=")
GEMM_LINES = (" ms/decode", "rel RMS vs native")
# the wide toy codec of tests/test_torch_bicodec.py (its WIDE); the tools'
# toy codec (profile_vocoder.TINY) adds a 384-channel input conv, which the
# "wide" subset takes
WIDE = dict(dec_channels=384)
CHAIN_MAX_ABS, CHAIN_RMS = 2e-3, 1e-4      # test_torch_bicodec.py's


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_source(name: str) -> str:
    with open(os.path.join(ROOT, "tools", f"{name}.py")) as f:
        return f.read()


def jax_assignment(name: str, var: str):
    """The value of the module-level assignment ``var`` in a JAX tool's
    source, parsed (literals only)."""
    for node in ast.parse(jax_source(name)).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == var for t in node.targets):
            return node.value
    raise KeyError(var)


def last_json(text: str):
    return json.loads(text.strip().splitlines()[-1])


def rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


# --------------------------------------------------------------------------
# the command line and the JAX tools' text
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_refuses_the_cpu_unless_asked(name):
    """Without ``device`` a tool asks for the card, and there is none
    here."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TOOLS[name].main(REFUSE_ARGV[name])


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_runs_as_a_module(name):
    r = subprocess.run([sys.executable, "-m",
                        f"rwkv_tts_tpu_torch.tools.{name}", "--help"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith(f"usage: {name}")


def test_the_jax_tools_have_these_lines():
    """The lines the tests hold the port's tools to are the JAX tools'
    own."""
    for name, frags in (("profile_vocoder", VOCODER_LINES),
                        ("profile_vocoder_batch", BATCH_LINES),
                        ("profile_vocoder_gemm", GEMM_LINES)):
        src = jax_source(name)
        for frag in frags:
            assert frag in src, (name, frag)


def test_shapes_and_subsets_are_the_jax_tools():
    """``SHAPES``, the subsets' predicates, B and S are the JAX tool's; the
    gemm variants and the sweep's defaults too."""
    assert ast.literal_eval(jax_assignment("profile_vocoder", "SHAPES")) \
        == [tuple(s) for s in profile_vocoder.SHAPES]
    preds = jax_assignment("profile_vocoder", "PREDS")
    names = [ast.literal_eval(k) for k in preds.keys]
    assert names == list(profile_vocoder.PREDS)
    for k, v in zip(names, preds.values):
        if isinstance(v, ast.Lambda):
            jax_pred = eval(compile(ast.Expression(v), "<pred>", "eval"))
            for Ci in (96, 192, 383, 384, 768, 1024):
                for K in (1, 7):
                    assert jax_pred(Ci, K) == \
                        profile_vocoder.PREDS[k](Ci, K), (k, Ci, K)
        else:
            assert profile_vocoder.PREDS[k] is None
    for name, var, want in (("profile_vocoder", "B", 8),
                            ("profile_vocoder_batch", "BATCH", 128),
                            ("profile_vocoder_batch", "S", 512),
                            ("profile_vocoder_gemm", "B", 8),
                            ("profile_vocoder_gemm", "S", 512)):
        assert ast.literal_eval(jax_assignment(name, var)) == want
    src = jax_source("profile_vocoder_gemm")
    assert '["native", "k1", "widek", "both"]' in src
    assert list(profile_vocoder_gemm.VARIANTS) == ["native", "k1", "widek",
                                                   "both"]
    assert "default=[4, 8, 16, 32]" in jax_source("profile_vocoder_batch")
    a = profile_vocoder_batch._args([])
    assert (a.subs, a.iters, a.batch, a.latents) == ([4, 8, 16, 32], 3, 128,
                                                     512)
    for argv, mode, which in (([], "shapes", []),
                              (["decode"], "decode", ["all"]),
                              (["impl"], "impl", ["mxu_fused"])):
        a = profile_vocoder._args(argv)
        assert (a.mode, a.which, a.batch, a.latents) == (mode, which, 8, 512)


# --------------------------------------------------------------------------
# profile_vocoder
# --------------------------------------------------------------------------

def test_profile_vocoder_shapes_prints_the_jax_lines(capsys):
    """A line per shape in the JAX tool's form, then the JSON line: the
    ten shapes (T cut), each kernel output within 2e-5 of
    ``conv1d_plain``, walls for native, kernel and cuDNN bf16 (busy ms for
    the last two, None on the CPU), the bound
    by bytes or operations, no device reading on the CPU, no weight packed
    in a timed call."""
    packs = C1.PACKS["conv1d"]
    out = profile_vocoder.main(TOY_ARGV["shapes"], device="cpu")
    text = capsys.readouterr().out
    lines = [l for l in text.splitlines() if " GF/ms) | mxu " in l]
    assert [l.split(":")[0] for l in lines] == \
        [s[0] for s in profile_vocoder.SHAPES]
    assert last_json(text) == json.loads(json.dumps(out))
    assert list(out["shapes"]) == [s[0] for s in profile_vocoder.SHAPES]
    for (label, Ci, O, T, K, dil), r in zip(profile_vocoder.SHAPES,
                                            out["shapes"].values()):
        assert (r["Ci"], r["O"], r["K"], r["dilation"]) == (Ci, O, K, dil)
        assert r["T"] == max(1, T // 512) and r["batch"] == 1
        assert r["max_rel_err"] <= profile_vocoder.SHAPE_TOL
        assert r["native_ms"] > 0
        for k in ("mxu", "cudnn_bf16"):
            assert r[f"{k}_ms"] > 0 and r[f"{k}_busy_ms"] is None
        assert r["bound_by"] in ("bytes", "operations") and r["bound_ms"] > 0
    assert C1.PACKS["conv1d"] == packs


def test_profile_vocoder_decode_prints_the_jax_lines(capsys):
    """``decode[<which>]: X ms`` per subset, then the JSON line: each
    waveform finite within [-1, 1]; the routed calls per decode those of
    the toy codec (the input conv and the two wide blocks' 12 convs under
    all and narrow (every routed conv is narrower than 384 but the input
    conv), 6 k = 1 convs under k1, the input conv alone under wide); no
    rel RMS for native; eager, said so; the module's conv put back."""
    real = P._conv1d
    out = profile_vocoder.main(TOY_ARGV["decode"], device="cpu")
    assert P._conv1d is real
    text = capsys.readouterr().out
    assert [l for l in text.splitlines() if l.startswith("decode[")] == \
        [f"decode[{k}]: {out['decode'][k]['wall_ms']:.1f} ms"
         for k in ("all", "k1", "wide", "narrow", "native")]
    assert last_json(text) == json.loads(json.dumps(out))
    assert out["graphed"] is False and "eagerly" in out["eager"]
    d = out["decode"]
    assert {k: d[k]["routed_calls"] for k in d} == \
        {"all": 13, "k1": 6, "wide": 1, "narrow": 12, "native": 0}
    for k, r in d.items():
        assert r["finite"] and r["max_abs"] <= 1.0
        assert r["busy_ms"] is None and r["top_kernels"] is None
        assert r["conv1d_launches"] == 0
        assert (r["rel_rms_vs_native"] > 0) == (k != "native")


def test_profile_vocoder_impl_prints_the_jax_lines(capsys):
    """``decode[conv_impl=<impl>]: X ms`` per impl through
    ``prepare_params`` and ``decode``, no swap: mxu equals the all
    subset's dispatch (the same convs to the same kernel)."""
    out = profile_vocoder.main(TOY_ARGV["impl"], device="cpu")
    text = capsys.readouterr().out
    assert [l.split(":")[0] for l in text.splitlines()
            if l.startswith("decode[")] == \
        [f"decode[conv_impl={k}]" for k in ("native", "mxu", "mxu_fused")]
    assert last_json(text) == json.loads(json.dumps(out))
    im = out["impl"]
    assert im["native"]["rel_rms_vs_native"] == 0.0
    assert im["mxu"]["rel_rms_vs_native"] > 0
    assert all(r["finite"] and r["max_abs"] <= 1.0 for r in im.values())
    sub = profile_vocoder.main(["decode", "all"] + TOY, device="cpu")
    assert sub["decode"]["all"]["rel_rms_vs_native"] == \
        im["mxu"]["rel_rms_vs_native"]


def test_dispatch_puts_the_conv_back_and_packs_once():
    """The swap is undone on an error inside it; the routed weights are
    packed when the swap begins, none during a decode; a weight the map
    does not hold is refused, not packed."""
    raw, cfg = profile_vocoder.codec(True, torch.device("cpu"))
    g, s = profile_vocoder.decode_tokens(cfg, 1, 8, torch.device("cpu"))
    real = P._conv1d
    with pytest.raises(ZeroDivisionError):
        with profile_vocoder.dispatching(raw, "all"):
            assert P._conv1d is not real
            1 / 0
    assert P._conv1d is real
    with profile_vocoder.dispatching(raw, "all") as seen:
        packs = C1.PACKS["conv1d"]
        P.decode(raw, g, s, cfg)
        assert C1.PACKS["conv1d"] == packs and seen["routed"] == 13
        w = raw["wavegen"]["in_w"].clone()
        with pytest.raises(RuntimeError, match="no packed copy"):
            P._conv1d(torch.zeros((1, 384, 8)), w, padding=3)


# the JAX decode under a subset: the JAX tool's dispatch with conv1d_mxu in
# interpret mode, through a fresh jit of decode.__wrapped__ (the jitted
# decode would not retrace), the module's _conv1d put back after
@pytest.fixture(scope="module")
def jax_decoder():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from rwkv_tts_tpu.config import BiCodecConfig as JConfig
    from rwkv_tts_tpu.models import bicodec as J
    from rwkv_tts_tpu.ops.conv1d import conv1d_mxu

    codecs, memo = {}, {}

    def codec(kw):
        key = tuple(sorted(kw.items()))
        if key not in codecs:
            jcfg = JConfig.tiny(**kw)
            jp = J.init_params(jcfg, jax.random.PRNGKey(0))
            codecs[key] = (jcfg, jp, BiCodecConfig.tiny(**kw),
                           bridge.bicodec_params(jp, device="cpu"))
        return codecs[key]

    def decode(kw, which, g, s):
        key = (tuple(sorted(kw.items())), which)
        if key in memo:
            return memo[key]
        jcfg, jp = codec(kw)[:2]
        pred = profile_vocoder.PREDS[which]
        native, seen = J._conv1d, {"routed": 0}

        def dispatch(x, w, b=None, stride=1, dilation=1, groups=1,
                     padding=0):
            O, Ci, K = w.shape
            if (stride == 1 and groups == 1 and O >= 96 and Ci >= 96
                    and pred(Ci, K)):
                seen["routed"] += 1
                return conv1d_mxu(x, w, b, dilation=dilation,
                                  padding=padding,
                                  compute_dtype=jnp.bfloat16,
                                  out_dtype=x.dtype, interpret=True)
            return native(x, w, b, stride, dilation, groups, padding)

        if pred is not None:
            J._conv1d = dispatch
        try:
            jf = jax.jit(lambda p_, g_, s_: J.decode.__wrapped__(p_, g_, s_,
                                                                 jcfg))
            wav = np.asarray(jf(jp, g.astype(np.int32), s.astype(np.int32)))
        finally:
            J._conv1d = native
        memo[key] = (wav, seen["routed"])
        return memo[key]

    return codec, decode


def subset_tokens():
    rng = np.random.default_rng(1)
    return rng.integers(0, 4096, (2, 32)), rng.integers(0, 8192, (2, 24))


@pytest.mark.parametrize("which,kw", [
    ("all", WIDE), ("k1", WIDE), ("narrow", WIDE), ("wide", WIDE),
    ("native", WIDE), ("wide", profile_vocoder.TINY)],
    ids=["all", "k1", "narrow", "wide_routes_none", "native", "wide"])
def test_decode_subset_matches_jax(jax_decoder, which, kw):
    """The port's decode under each subset against the JAX decode under
    the same subset, B 2, S 24, on bridged weights: both route the same
    number of convs; where they route some, the port lies nearer JAX's
    subset run than the subset moves JAX from its native run; where they
    route none (native; wide at the WIDE codec, whose widest conv has
    192 input channels), each is its package's native decode and the two
    agree within the f32 chain tolerance."""
    codec, decode = jax_decoder
    _, _, cfg, pt = codec(kw)
    g, s = subset_tokens()
    base, _ = decode(kw, "native", g, s)
    want, n_jax = decode(kw, which, g, s)
    gt, st = torch.from_numpy(g), torch.from_numpy(s)
    real = P._conv1d
    plain = P.decode(pt, gt, st, cfg).numpy()
    with profile_vocoder.dispatching(pt, which) as seen:
        got = P.decode(pt, gt, st, cfg).numpy()
    assert P._conv1d is real
    assert got.shape == (2, 24 * 320) and np.isfinite(got).all()
    assert np.abs(got).max() <= 1.0
    assert seen["routed"] == n_jax
    if n_jax:
        policy = rms(want - base)
        assert policy > 0.05
        assert rms(got - want) < policy
    else:
        assert np.array_equal(got, plain)
        assert np.abs(got - want).max() <= CHAIN_MAX_ABS
        assert rms(got - want) <= CHAIN_RMS


def test_native_subset_is_the_plain_decode_bit_for_bit():
    """Under "native" nothing is swapped: the model's own decode, bit for
    bit, at the tools' toy codec."""
    raw, cfg = profile_vocoder.codec(True, torch.device("cpu"))
    g, s = (torch.from_numpy(x) for x in subset_tokens())
    want = P.decode(raw, g, s, cfg)
    real = P._conv1d
    with profile_vocoder.dispatching(raw, "native") as seen:
        assert P._conv1d is real
        got = P.decode(raw, g, s, cfg)
    assert seen["routed"] == 0 and torch.equal(got, want)


# --------------------------------------------------------------------------
# profile_vocoder_gemm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("K,dil", [(7, 1), (7, 3), (7, 9), (1, 1)])
def test_gemm_conv_matches_jax_conv1d(K, dil):
    """The shifted sum against the JAX package's ``bicodec._conv1d``
    computed in f32 on the bf16-rounded x and w (the products of bf16
    values are exact in f32): within 1e-5 of the output's largest value;
    the result keeps x's type."""
    pytest.importorskip("jax")
    from rwkv_tts_tpu.models import bicodec as J

    rng = np.random.default_rng(K * 10 + dil)
    x = torch.from_numpy(rng.standard_normal((2, 96, 50)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((80, 96, K)) / np.sqrt(96 * K))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(80).astype(np.float32))
    pad = (K - 1) * dil // 2
    got = profile_vocoder_gemm.gemm_conv(x, w, b, dil, pad)
    xr, wr = (t.to(torch.bfloat16).float().numpy() for t in (x, w))
    want = np.asarray(J._conv1d(xr, wr, b.numpy(), 1, dil, 1, pad))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_profile_vocoder_gemm_prints_the_jax_lines(capsys):
    """A line per variant in the JAX tool's form, then the JSON line: the
    shifted sums take the toy codec's 6 k = 1 convs (k1), its one Ci ≥ 384
    k = 7 conv (widek) or both, each waveform finite; native routes none
    and reads 0 rel RMS; the module's conv put back."""
    real = P._conv1d
    out = profile_vocoder_gemm.main(TOY, device="cpu")
    assert P._conv1d is real
    text = capsys.readouterr().out
    lines = [l for l in text.splitlines() if " ms/decode" in l]
    assert [l.split(":")[0].strip() for l in lines] == \
        list(profile_vocoder_gemm.VARIANTS)
    assert all("rel RMS vs native" in l and "first call" in l
               for l in lines)
    assert last_json(text) == json.loads(json.dumps(out))
    v = out["variants"]
    assert {k: r["routed_calls"] for k, r in v.items()} == \
        {"native": 0, "k1": 6, "widek": 1, "both": 7}
    assert v["native"]["rel_rms_vs_native"] == 0.0
    for k, r in v.items():
        assert r["finite"] and r["wall_ms"] > 0 and r["busy_ms"] is None
        assert (r["rel_rms_vs_native"] > 0) == (k != "native")


# --------------------------------------------------------------------------
# profile_vocoder_batch
# --------------------------------------------------------------------------

def test_sub_batches_match_one_call():
    """The leg at sub-batches 1, 2 and 4 on the tiny codec against the same
    utterances in one call. Sub-batches of 2 and 4 lie within 1e-5 (the
    CPU runs each row through the same arithmetic: measured bit for bit).
    At batch 1 the CPU's libraries take other GEMM and conv paths (the
    speaker projection and ``F.conv1d`` read 1e-6 to 2e-6 of their scale
    apart at batch 1 and 4), and the random-init wave generator grows that
    rounding about 5x a block: the waveforms are held to
    ``test_torch_bicodec.py``'s f32 chain tolerance at this codec, and
    the wave generator's input to f32 rounding."""
    cfg = BiCodecConfig.tiny()
    gen = torch.Generator().manual_seed(1)
    params = P.prepare_params(P.init_params(cfg, gen, "cpu"), cfg)
    glob, sem = profile_vocoder_batch.leg_tokens(cfg, 4, 24)
    whole = P.decode_host(params, glob, sem, cfg)
    assert whole.shape == (4, 24 * cfg.hop)
    for vb in (1, 2, 4):
        parts = profile_vocoder_batch.detokenize_leg(params, cfg, glob, sem,
                                                     vb)
        assert len(parts) == 4 // vb
        diff = (torch.cat(parts) - whole).double()
        if vb > 1:
            assert diff.abs().max() <= 1e-5, vb
        else:
            assert diff.abs().max() <= CHAIN_MAX_ABS
            assert diff.pow(2).mean().sqrt() <= CHAIN_RMS

    def wavegen_input(g, s):
        d = P.speaker_detokenize(params["speaker"], torch.from_numpy(g), cfg)
        zq = P.fvq_detokenize(params["quantizer"], torch.from_numpy(s))
        return P.prenet_forward(params["prenet"], zq, d, cfg) + d[:, :, None]

    x4 = wavegen_input(glob, sem)
    x1 = torch.cat([wavegen_input(glob[i:i + 1], sem[i:i + 1])
                    for i in range(4)])
    assert (x1 - x4).abs().max() <= 1e-5 * x4.abs().max()


def test_profile_vocoder_batch_prints_the_jax_lines(capsys):
    """``voc_b=…: X s for BxS (Y xRT vocoder-only)`` per size, ``best:``,
    then the JSON line: seconds and xRT agree with the audio (B · S / 50
    s), every size eager on the CPU, no memory reading."""
    out = profile_vocoder_batch.main(TOY_ARGV["batch"], device="cpu")
    text = capsys.readouterr().out
    lines = [l for l in text.splitlines() if l.startswith("voc_b=")]
    assert [l.split(":")[0] for l in lines] == \
        ["voc_b=  1", "voc_b=  2", "voc_b=  4"]
    assert all(" s for 4x24 (" in l and "xRT vocoder-only)" in l
               for l in lines)
    assert f"best: voc_b={out['best']} (" in text
    assert last_json(text) == json.loads(json.dumps(out))
    assert out["audio_sec"] == pytest.approx(4 * 24 / 50)
    for vb, r in out["voc_b"].items():
        assert r["xrt"] == pytest.approx(out["audio_sec"] / r["seconds"])
        assert r["calls"] == 4 // int(vb) and r["mode"] == "eager"
        assert r["peak_allocated_mib"] is None
    assert min(out["voc_b"], key=lambda k: out["voc_b"][k]["seconds"]) \
        == str(out["best"])


@pytest.mark.parametrize("error", [torch.cuda.OutOfMemoryError, ValueError])
def test_the_sweep_catches_only_running_out_of_memory(monkeypatch, capsys,
                                                     error):
    """Out of memory at a size prints the JAX tool's ``FAILED`` line and
    the sweep goes on; any other error propagates."""
    real = profile_vocoder_batch.detokenize_leg

    def leg(params, cfg, glob, sem, voc_b, graphs=None):
        if voc_b == 2:
            raise error("at voc_b 2")
        return real(params, cfg, glob, sem, voc_b, graphs)

    monkeypatch.setattr(profile_vocoder_batch, "detokenize_leg", leg)
    if error is ValueError:
        with pytest.raises(ValueError, match="at voc_b 2"):
            profile_vocoder_batch.main(TOY_ARGV["batch"], device="cpu")
        return
    out = profile_vocoder_batch.main(TOY_ARGV["batch"], device="cpu")
    text = capsys.readouterr().out
    assert "voc_b=2: FAILED (OutOfMemoryError: at voc_b 2)" in text
    assert "failed" in out["voc_b"]["2"]
    assert "seconds" in out["voc_b"]["1"] and "seconds" in out["voc_b"]["4"]


# --------------------------------------------------------------------------
# chip_smoke.py's vocoder_tools phase
# --------------------------------------------------------------------------

def test_vocoder_tools_phase_on_the_cpu():
    """The phase at toy depth: its checks pass, seven lines, no launch on
    the CPU, and the summary entry with its seconds and a card's launches
    under 250 bytes."""
    vt = chip_smoke.vocoder_tools(torch, "cpu", TOY_ARGV)
    assert not any(vt["launches"].values())
    lines = list(chip_smoke.vocoder_tools_lines(vt, "cpu"))
    assert len(lines) == 7
    assert all(l.startswith("vocoder_tools: ") for l in lines)
    entry = chip_smoke._compact({"s": 45.6789, "launches": {
        "conv1d": 12345, "conv1d_prologue": 12345},
        **chip_smoke.vocoder_tools_summary(vt)})
    assert len(json.dumps(entry, separators=(",", ":"))) <= 250


def test_vocoder_tools_phase_depths():
    """The phase's cuts, as ``PERF.md`` §4 lists them."""
    a = chip_smoke.VOCODER_TOOLS_ARGV
    sh = profile_vocoder._args(a["shapes"])
    assert (sh.mode, sh.iters, sh.batch, sh.t_div) == ("shapes", None, 8, 1)
    for mode, which in (("decode", ["all", "k1", "wide", "narrow",
                                    "native"]),
                        ("impl", ["native", "mxu", "mxu_fused"])):
        d = profile_vocoder._args(a[mode])
        assert (d.mode, d.which, d.iters, d.batch, d.latents,
                d.tiny_codec) == (mode, which, 2, 8, 512, False)
    b = profile_vocoder_batch._args(a["batch"])
    assert (b.batch, b.latents, b.subs, b.iters, b.tiny_codec) == \
        (32, 512, [4, 8, 16], 1, False)
    assert [4 * 512 <= P.DECODE_GRAPH_MAX_LATENTS < n * 512
            for n in (8, 16)] == [True, True]
    g = profile_vocoder_gemm._args(a["gemm"])
    assert (g.variants, g.iters, g.batch, g.latents) == \
        (list(profile_vocoder_gemm.VARIANTS), 2, 8, 512)
    assert chip_smoke.PHASES.index("vocoder_tools") == \
        chip_smoke.PHASES.index("lm_tools") + 1


def test_run_tail_fits_with_the_vocoder_tools_path():
    """The kernels line with the ``vocoder_tools`` path beside every
    earlier path (a launch count of seven digits for every entry on
    each), the summary line at its budget and the ok line stay inside
    14 KB, well within the 24 KB of output a run's record keeps."""
    x = 0.040559900000000065
    stats = {name: {"max_abs_err": x, "ms": x, "plain_ms": x, "bound_ms": x,
                    "bound_by": "bytes", "library_ms": x}
             for name in chip_smoke.KERNEL_ENTRIES}
    paths = {p: {k: 1234567 for k in chip_smoke.KERNEL_ENTRIES}
             for p in ("tools", "lm_tools", "vocoder_tools", "parity", "tp",
                       "main_path", "cloning", "quantized", "streaming",
                       "server", "soak", "checkpoint",
                       "checkpoint_published")}
    kernels = json.dumps({"kernels": chip_smoke.kernel_entries(stats,
                                                               paths)})
    ok = json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}})
    assert chip_smoke.SUMMARY_BYTES + len(kernels) + len(ok) + 3 \
        < 14 * 1024


@pytest.mark.cuda
def test_gemm_conv_on_the_card_matches_the_cpu():
    """On a card each product is cuBLAS's bf16 GEMM with an f32 result
    (``torch.mm(..., out_dtype=torch.float32)``): within 1e-5 of the
    output's largest value of the CPU's f32 product of the same bf16
    values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 384, 300), generator=g)
    w = torch.randn((384, 384, 7), generator=g) / (384 * 7) ** 0.5
    b = torch.randn((384,), generator=g)
    want = profile_vocoder_gemm.gemm_conv(x, w, b, 3, 9)
    got = profile_vocoder_gemm.gemm_conv(x.cuda(), w.cuda(), b.cuda(), 3,
                                         9).cpu()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
