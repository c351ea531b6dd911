"""The port's prefab reader (``rwkv_tts_tpu_torch/models/prefab``, its own
copy of the JAX package's) against ``rwkv_tts_tpu/models/prefab`` on the
same CBOR files, on the CPU: the decoded documents, the flattened tensors
(f16 and f32 payloads, both Int8 variants) and the ``load_rwkv7`` tree of
a prefab equal the JAX results bit for bit, and every malformed file
raises the same ``CborError`` (truncated CBOR, NF4, a drifted Int8 struct,
a bare u8 blob, unmappable names, a bad minmax size, fuzzed bytes)."""

import random

import numpy as np
import pytest
import torch

from rwkv_tts_tpu.models import convert as JC
from rwkv_tts_tpu.models import prefab as JP
from rwkv_tts_tpu_torch.models import convert as PC
from rwkv_tts_tpu_torch.models import prefab as PP

from test_convert import make_rwkv7_checkpoint
from test_prefab import _write_prefab, enc
from test_torch_convert import assert_same_tree


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("variant", ["f32", "f16", "f16_unwrapped",
                                     "int8_blinkdl", "int8_fused"])
def test_prefab_loads_as_jax(tmp_path, variant):
    t = make_rwkv7_checkpoint()
    p = str(tmp_path / f"{variant}.prefab")
    kw = {"f32": dict(dtype=np.float32), "f16": dict(dtype=np.float16),
          "f16_unwrapped": dict(dtype=np.float16, wrap_fp16=False),
          "int8_blinkdl": dict(dtype=np.float32, quant_int8=True),
          "int8_fused": dict(dtype=np.float32, quant_int8="fused")}[variant]
    _write_prefab(p, t, **kw)
    mine, theirs = PP.read_prefab(p), JP.read_prefab(p)
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        assert mine[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(mine[k], theirs[k])
    for dtype in ("float32", "bfloat16"):
        jp, jcfg = JC.load_rwkv7(p, dtype=dtype)
        pp, pcfg = PC.load_rwkv7(p, dtype=dtype, device="cpu")
        assert pcfg.__dict__ == jcfg.__dict__
        assert_same_tree(pp, jp)


def test_quantizers_equal_jax():
    w = np.random.default_rng(1).standard_normal((96, 64)).astype(
        np.float32) * 0.3
    for a, b in zip(PP.quantize_int8_blinkdl(w),
                    JP.quantize_int8_blinkdl(w)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(PP.quantize_int8_blockminmax(w, 128),
                    JP.quantize_int8_blockminmax(w, 128)):
        np.testing.assert_array_equal(a, b)


def test_cbor_documents_decode_as_jax():
    docs = [{"a": 1, "b": -5, "c": [1.5, True, None, "txt"],
             "d": b"\x00\x01", "big": 2 ** 40, "neg": -(2 ** 33)},
            [1, [2, [3, {"x": 2.5}]]]]
    for d in docs:
        assert PP.decode_cbor(enc(d)) == JP.decode_cbor(enc(d)) == d
    for raw in (b"\x9f" + enc(1) + enc(2) + b"\xff", b"\xf9\x3c\x00",
                bytes([0xD8, 42]) + enc(7),
                b"\x5f" + enc(b"ab") + enc(b"c") + b"\xff"):
        assert PP.decode_cbor(raw) == JP.decode_cbor(raw)


def _raises_alike(buf):
    """Both decoders reject ``buf`` with CborError, or both decode it to
    the same item."""
    out = []
    for mod in (PP, JP):
        try:
            out.append(("ok", mod.decode_cbor(buf)))
        except mod.CborError as e:
            out.append(("error", str(e)))
    assert out[0] == out[1], buf.hex()


def test_malformed_cbor_fails_as_in_jax():
    for buf in (b"\x82" + enc(1), b"\x1f", b"\x3f",
                bytes([0xDF]) + enc(1), b"\xff", b""):
        _raises_alike(buf)
    rng = random.Random(0)
    for _ in range(200):
        _raises_alike(bytes(rng.randrange(256)
                            for _ in range(rng.randrange(0, 48))))
    valid = enc({"a": [1, 2.5, "x"], "b": b"\x00" * 8})
    for cut in range(len(valid)):
        _raises_alike(valid[:cut])


@pytest.mark.parametrize("doc,match", [
    ({"tensor": {"head": {"NF4": {"w": {"shape": [4, 4],
                                        "data": b"\x00" * 8}}}}},
     "quantized|NF4"),
    ({"tensor": {"head": {"Int8": {"w": {"shape": [4, 4],
                                         "data": b"\x00" * 16},
                                   "scales": {"shape": [4],
                                              "data": b"\x00" * 16}}}}},
     "expected w \\+ mx/rx/my/ry"),
    ({"tensor": {"head": {"Int8": {"w": {"shape": [4, 4],
                                         "data": b"\x00" * 16},
                                   "m": {"shape": [4],
                                         "data": b"\x00" * 16}}}}},
     "matches no per-block minmax"),
    ({"tensor": {"head": {"shape": [4, 4], "data": b"\x7f" * 16}}},
     "raw byte payload"),
    ({"stuff": {"alpha": {"shape": [2, 2], "data": b"\x00" * 16}}},
     "none map onto"),
    ({"info": {"version": "V7"}}, "found no tensors"),
])
def test_bad_prefabs_raise_as_in_jax(tmp_path, doc, match):
    p = str(tmp_path / "bad.prefab")
    with open(p, "wb") as f:
        f.write(enc(doc))
    for mod in (PP, JP):
        with pytest.raises(mod.CborError, match=match):
            mod.read_prefab(p)
    # through the LM loader both refuse with the same sniffing error
    for read in (PC.read_lm_checkpoint, JC.read_lm_checkpoint):
        with pytest.raises(ValueError, match="neither a safetensors"):
            read(p)
