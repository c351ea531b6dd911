"""The port's checkpoint import (``rwkv_tts_tpu_torch/models/convert``)
against the JAX package's (``rwkv_tts_tpu/models/convert``) on the same
seeded files, on the CPU: every loader's tree equals ``utils/bridge`` of the
JAX loader's tree leaf for leaf and bit for bit (safetensors in F32, BF16
and F16 storage, the naming variants, the wav2vec2 and BiCodec state
dicts, the ONNX initializer reader, the ``.npz`` checkpoint written by
either package and read by the other), and the error cases raise as in
JAX: a v6 checkpoint, a missing key, a short or foreign file."""

import json
import struct

import jax
import numpy as np
import pytest
import torch

from rwkv_tts_tpu.config import BiCodecConfig as JBiCodecConfig
from rwkv_tts_tpu.config import RwkvConfig as JRwkvConfig
from rwkv_tts_tpu.config import Wav2Vec2Config as JWav2Vec2Config
from rwkv_tts_tpu.models import convert as JC
from rwkv_tts_tpu_torch.config import BiCodecConfig, Wav2Vec2Config
from rwkv_tts_tpu_torch.models import convert as PC
from rwkv_tts_tpu_torch.utils import bridge

from test_convert import (_field, _varint, make_rwkv7_checkpoint,
                          write_safetensors)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves(tree):
    return [(jax.tree_util.keystr(k), v)
            for k, v in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: x is None)]


def assert_same_tree(got, want):
    """``got`` (the port's tree) equals ``want`` (a tree of tensors, or of
    JAX / numpy arrays, which are bridged) in structure, dtypes and bits;
    None leaves match None."""
    g, w = leaves(got), leaves(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        if b is None:
            assert a is None, k
            continue
        if not isinstance(b, torch.Tensor):
            b = bridge.to_tensor(b, "cpu")
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        assert torch.equal(a.cpu(), b), k


def write_typed_safetensors(path, tensors, dtype):
    """Float tensors stored as ``dtype`` ("BF16", "F16" or "F32")."""
    header, blobs, off = {}, [], 0
    for name, arr in tensors.items():
        t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        if dtype == "BF16":
            raw = t.to(torch.bfloat16).view(torch.int16).numpy().tobytes()
        elif dtype == "F16":
            raw = t.numpy().astype("<f2").tobytes()
        else:
            raw = t.numpy().astype("<f4").tobytes()
        header[name] = {"dtype": dtype, "shape": list(arr.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    h = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)))
        f.write(h)
        f.write(b"".join(blobs))


@pytest.mark.parametrize("storage", ["F32", "BF16", "F16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_rwkv7_equals_jax(tmp_path, storage, dtype):
    p = str(tmp_path / "webrwkv.safetensors")
    write_typed_safetensors(p, make_rwkv7_checkpoint(), storage)
    jp, jcfg = JC.load_rwkv7(p, dtype=dtype)
    pp, pcfg = PC.load_rwkv7(p, dtype=dtype, device="cpu")
    assert pcfg.__dict__ == jcfg.__dict__
    assert_same_tree(pp, jp)


def test_read_safetensors_equals_jax(tmp_path):
    """Every stored type the JAX reader takes, as float32 numpy."""
    rng = np.random.default_rng(0)
    p = str(tmp_path / "mixed.safetensors")
    parts = {"f32": ("F32", rng.normal(size=(3, 5)).astype("<f4")),
             "f16": ("F16", rng.normal(size=(7,)).astype("<f2")),
             "i64": ("I64", np.arange(-3, 3, dtype="<i8")),
             "i32": ("I32", np.arange(5, dtype="<i4").reshape(5, 1)),
             "u8": ("U8", np.arange(3, dtype=np.uint8))}
    header, blobs, off = {"__metadata__": {"format": "pt"}}, [], 0
    for name, (dt, arr) in parts.items():
        raw = arr.tobytes()
        header[name] = {"dtype": dt, "shape": list(arr.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    bf = torch.randn(2, 3).to(torch.bfloat16)
    header["bf16"] = {"dtype": "BF16", "shape": [2, 3],
                      "data_offsets": [off, off + 12]}
    blobs.append(bf.view(torch.int16).numpy().tobytes())
    h = json.dumps(header).encode()
    with open(p, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + b"".join(blobs))
    mine, theirs = PC.read_safetensors(p), JC.read_safetensors(p)
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        assert mine[k].dtype == np.float32 == theirs[k].dtype
        np.testing.assert_array_equal(mine[k], theirs[k])
    # the LM reader keeps each stored type (u8 sits at an odd offset)
    raw = PC.read_safetensors_tensors(p)
    assert raw["bf16"].dtype == torch.bfloat16 and torch.equal(raw["bf16"],
                                                               bf)
    assert raw["i64"].dtype == torch.int64


def test_infer_config_equals_jax():
    t = make_rwkv7_checkpoint()
    assert PC.infer_config(t).__dict__ == JC.infer_config(t).__dict__
    tt = {k: torch.from_numpy(v) for k, v in t.items()}
    assert PC.infer_config(tt, "float32").__dict__ == \
        JC.infer_config(t, "float32").__dict__


def test_naming_variants_load_as_jax(tmp_path):
    """Wrapper prefixes, spelled-out submodules, Linear-child loras and
    transposed rectangular saves land on the canonical tree, in both
    packages alike."""
    t = make_rwkv7_checkpoint()
    variant = {}
    for k, v in t.items():
        nk = ("rwkv." + k).replace(".att.", ".attention.").replace(
            ".ffn.", ".feed_forward.")
        nk = {"rwkv.emb.weight": "rwkv.embeddings.weight",
              "rwkv.head.weight": "lm_head.weight",
              "rwkv.ln_out.weight": "rwkv.ln_f.weight",
              "rwkv.ln_out.bias": "rwkv.ln_f.bias"}.get(nk, nk)
        for ln in ("w1", "w2", "a1", "a2", "v1", "v2", "g1", "g2"):
            if nk.endswith(f".attention.{ln}"):
                nk += ".weight"
                v = v.T
        if nk.endswith("feed_forward.key.weight") or nk.endswith(
                "feed_forward.value.weight"):
            v = v.T
        variant[nk] = np.ascontiguousarray(v)
    p0 = str(tmp_path / "canon.safetensors")
    p1 = str(tmp_path / "variant.safetensors")
    write_safetensors(p0, t)
    write_safetensors(p1, variant)
    canon, _ = PC.load_rwkv7(p0, dtype="float32", device="cpu")
    got, cfg = PC.load_rwkv7(p1, dtype="float32", device="cpu")
    jgot, jcfg = JC.load_rwkv7(p1, dtype="float32")
    assert cfg.__dict__ == jcfg.__dict__
    assert_same_tree(got, jgot)
    assert_same_tree(got, canon)


def test_error_cases_raise_as_in_jax(tmp_path):
    """A v6 checkpoint, a missing layer key, a short file and a foreign
    file raise the JAX loader's errors."""
    t = dict(make_rwkv7_checkpoint())
    t["blocks.0.att.time_decay"] = np.zeros(8, np.float32)
    v6 = str(tmp_path / "v6.safetensors")
    write_safetensors(v6, t)
    for load in (JC.load_rwkv7, lambda p: PC.load_rwkv7(p, device="cpu")):
        with pytest.raises(ValueError, match="V7 only"):
            load(v6)
    t = dict(make_rwkv7_checkpoint())
    del t["blocks.1.att.k_k"]
    miss = str(tmp_path / "miss.safetensors")
    write_safetensors(miss, t)
    for load in (JC.load_rwkv7, lambda p: PC.load_rwkv7(p, device="cpu")):
        with pytest.raises(KeyError, match="blocks.1.att.k_k"):
            load(miss)
    for name, blob in (("short.bin", b"\x01\x02"), ("zeros.bin", b"\0" * 16),
                       ("garbage.bin", b"\x00\x01\x02garbage")):
        p = str(tmp_path / name)
        with open(p, "wb") as f:
            f.write(blob)
        for read in (JC.read_lm_checkpoint, PC.read_lm_checkpoint):
            with pytest.raises(ValueError, match="neither a safetensors"):
                read(p)


def test_onnx_initializers_equal_jax(tmp_path):
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    tensor = (_field(1, 0, _varint(3)) + _field(1, 0, _varint(4))
              + _field(2, 0, _varint(1)) + _field(8, 2, b"my.weight")
              + _field(9, 2, arr.tobytes()))
    ints = np.array([5, -2], np.int64)
    packed = b"".join(_varint(int(v) & ((1 << 64) - 1)) for v in ints)
    t2 = (_field(1, 0, _varint(2)) + _field(2, 0, _varint(7))
          + _field(8, 2, b"my.bias") + _field(7, 2, packed))
    p = str(tmp_path / "toy.onnx")
    with open(p, "wb") as f:
        f.write(_field(7, 2, _field(5, 2, tensor) + _field(5, 2, t2)))
    mine, theirs = PC.read_onnx_initializers(p), JC.read_onnx_initializers(p)
    assert sorted(mine) == sorted(theirs) == ["my.bias", "my.weight"]
    for k in theirs:
        assert mine[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(mine[k], theirs[k])
    np.testing.assert_array_equal(mine["my.bias"], ints)


@pytest.fixture(scope="module")
def jax_trees():
    from rwkv_tts_tpu.models import bicodec, rwkv7
    from rwkv_tts_tpu.ops.quant import quantize_rwkv_params

    cfg = JRwkvConfig(n_layer=2, n_embd=128, head_size=64, vocab_size=500,
                      padded_vocab_size=512, decay_lora=16, a_lora=16,
                      v_lora=8, gate_lora=16, dtype="bfloat16",
                      param_dtype="bfloat16")
    base = rwkv7.init_params(cfg, jax.random.PRNGKey(0))
    codec = bicodec.init_params(JBiCodecConfig.tiny(),
                                jax.random.PRNGKey(1))
    codec["prenet"]["backbone"]["blocks"][0]["gamma"] = None
    return {"bf16": base, "int8": quantize_rwkv_params(base),
            "partial_int4": quantize_rwkv_params(base, quant_layers=1,
                                                 kind="int4"),
            "codec": codec}


@pytest.mark.parametrize("layout", ["bf16", "int8", "partial_int4", "codec"])
def test_npz_checkpoints_cross_between_packages(tmp_path, jax_trees,
                                                layout):
    """A JAX-written file loads in the port as the bridged tree, and the
    port's own file of that tree loads in JAX as the same tree (bf16 bits,
    tuples of segments, None leaves)."""
    tree = jax_trees[layout]
    jpath = str(tmp_path / "jax.npz")
    JC.save_checkpoint(tree, jpath)
    mine = PC.load_checkpoint(jpath, device="cpu")
    want = jax.tree_util.tree_map(lambda x: bridge.to_tensor(x, "cpu"), tree)
    assert_same_tree(mine, want)
    ppath = str(tmp_path / "port.npz")
    PC.save_checkpoint(mine, ppath)
    back = JC.load_checkpoint(ppath)
    assert_same_tree(jax.tree_util.tree_map(
        lambda x: bridge.to_tensor(x, "cpu"), back), want)
    if layout == "partial_int4":
        assert isinstance(mine["blocks"], tuple)


def w2v_state_dict(cfg, rng, weight_norm=True):
    """A HF-named wav2vec2 (stable layer norm) state dict; the positional
    conv in weight-norm form, and conv biases (xlsr-53's conv_bias)."""
    t = {}
    in_ch = 1
    for i, (oc, k) in enumerate(zip(cfg.conv_dims, cfg.conv_kernels)):
        b = f"wav2vec2.feature_extractor.conv_layers.{i}"
        t[f"{b}.conv.weight"] = rng.normal(0, 0.1, (oc, in_ch, k)).astype(
            np.float32)
        t[f"{b}.conv.bias"] = rng.normal(0, 0.1, oc).astype(np.float32)
        t[f"{b}.layer_norm.weight"] = 1 + rng.normal(0, 0.1, oc).astype(
            np.float32)
        t[f"{b}.layer_norm.bias"] = rng.normal(0, 0.1, oc).astype(np.float32)
        in_ch = oc
    H, C = cfg.hidden_size, cfg.conv_dims[-1]
    t["feature_projection.layer_norm.weight"] = np.ones(C, np.float32)
    t["feature_projection.layer_norm.bias"] = np.zeros(C, np.float32)
    t["model.feature_projection.projection.weight"] = rng.normal(
        0, 0.1, (H, C)).astype(np.float32)
    t["feature_projection.projection.bias"] = np.zeros(H, np.float32)
    pc = "encoder.pos_conv_embed.conv"
    if weight_norm:
        t[f"{pc}.weight_g"] = rng.uniform(0.5, 1.5, (1, 1, 128)).astype(
            np.float32)
        t[f"{pc}.weight_v"] = rng.normal(0, 0.1, (H, H // 16, 128)).astype(
            np.float32)
    else:
        t[f"{pc}.weight"] = rng.normal(0, 0.1, (H, H // 16, 128)).astype(
            np.float32)
    t[f"{pc}.bias"] = np.zeros(H, np.float32)
    t["encoder.layer_norm.weight"] = np.ones(H, np.float32)
    t["encoder.layer_norm.bias"] = np.zeros(H, np.float32)
    for i in range(cfg.num_layers):
        b = f"encoder.layers.{i}"
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            t[f"{b}.attention.{nm}.weight"] = rng.normal(
                0, 0.1, (H, H)).astype(np.float32)
            t[f"{b}.attention.{nm}.bias"] = rng.normal(0, 0.1, H).astype(
                np.float32)
        for nm in ("layer_norm", "final_layer_norm"):
            t[f"{b}.{nm}.weight"] = np.ones(H, np.float32)
            t[f"{b}.{nm}.bias"] = np.zeros(H, np.float32)
        t[f"{b}.feed_forward.intermediate_dense.weight"] = rng.normal(
            0, 0.1, (cfg.ffn_size, H)).astype(np.float32)
        t[f"{b}.feed_forward.intermediate_dense.bias"] = np.zeros(
            cfg.ffn_size, np.float32)
        t[f"{b}.feed_forward.output_dense.weight"] = rng.normal(
            0, 0.1, (H, cfg.ffn_size)).astype(np.float32)
        t[f"{b}.feed_forward.output_dense.bias"] = np.zeros(H, np.float32)
    return t


W2V = dict(num_layers=2, hidden_size=32, num_heads=2, ffn_size=64,
           conv_dims=(16,) * 7)


@pytest.mark.parametrize("weight_norm", [True, False])
def test_wav2vec2_weights_equal_jax(weight_norm):
    t = w2v_state_dict(Wav2Vec2Config(**W2V), np.random.default_rng(0),
                       weight_norm)
    mine = PC.load_wav2vec2_weights(t, Wav2Vec2Config(**W2V), device="cpu")
    theirs = JC.load_wav2vec2_weights(t, JWav2Vec2Config(**W2V))
    assert_same_tree(mine, theirs)
    with pytest.raises(KeyError, match="missing wav2vec2 tensor"):
        PC.load_wav2vec2_weights({}, Wav2Vec2Config(**W2V), device="cpu")


def test_bicodec_weights_equal_jax(tmp_path):
    """The torch reference's state dict (weight-normed convs folded) maps
    onto the same tree in both packages, the ECAPA head included; a state
    dict read back from a .pt file and a .safetensors file equals the
    in-memory one; a missing key names its near misses."""
    from torch_bicodec_ref import TorchBiCodec

    cfg = BiCodecConfig.tiny(feat_dim=24, semantic_codebook=64, mel_bins=16)
    torch.manual_seed(0)
    sd = {k: v.numpy() for k, v in TorchBiCodec(cfg).state_dict().items()}
    mine = PC.load_bicodec_weights(sd, cfg, device="cpu")
    theirs = JC.load_bicodec_weights(sd, JBiCodecConfig.tiny(
        feat_dim=24, semantic_codebook=64, mel_bins=16))
    assert_same_tree(mine, theirs)
    assert {"att1_w", "att2_w", "bn", "fc_w"} <= set(mine["speaker"]["ecapa"])
    pt = str(tmp_path / "bicodec.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pt)
    st = str(tmp_path / "bicodec.safetensors")
    write_safetensors(st, sd)
    for path in (pt, st):
        back = PC.load_state_dict_file(path)
        assert sorted(back) == sorted(JC.load_state_dict_file(path))
        assert_same_tree(PC.load_bicodec_weights(back, cfg, device="cpu"),
                         theirs)
    sd.pop("quantizer.codebook.weight")
    with pytest.raises(KeyError, match="closest checkpoint keys"):
        PC.load_bicodec_weights(sd, cfg, device="cpu")


def test_fold_weight_norm_equals_jax():
    rng = np.random.default_rng(3)
    t = {"a.weight_g": rng.uniform(0.5, 2, (6, 1, 1)).astype(np.float32),
         "a.weight_v": rng.normal(size=(6, 4, 3)).astype(np.float32),
         "b.parametrizations.weight.original0": rng.uniform(
             0.5, 2, (1, 1, 3)).astype(np.float32),
         "b.parametrizations.weight.original1": rng.normal(
             size=(6, 4, 3)).astype(np.float32),
         "c.bias": np.ones(3, np.float32)}
    mine, theirs = PC.fold_weight_norm(t), JC.fold_weight_norm(t)
    assert sorted(mine) == sorted(theirs) == ["a.weight", "b.weight",
                                              "c.bias"]
    for k in theirs:
        np.testing.assert_array_equal(mine[k], theirs[k])
