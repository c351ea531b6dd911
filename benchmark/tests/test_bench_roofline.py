"""Operation and byte counts of the roofline and mfu arithmetic against
values worked out by hand."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness.cell import load  # noqa: E402
from roofline import int8_gemm, model_ops, peaks, wkv_decode  # noqa: E402

LM = load("int8.backlog").config["lm"]
CODEC = load("int8.backlog").config["codec"]


def test_int8_product_bytes_at_128_rows():
    # 2048 x 2048 int8 weight, 128 x 2048 int8 input, 128 x 2048 int32 out
    assert int8_gemm.call_bytes(128, 2048, 2048) == \
        4_194_304 + 262_144 + 1_048_576
    assert int8_gemm.call_ops(128, 2048, 2048) == 1_073_741_824
    # bound by bytes: 5.505 MB at 3.35 TB/s
    assert int8_gemm.call_bound_s(128, 2048, 2048) == pytest.approx(
        5_505_024 / 3.35e12)
    # a step: per layer 4 C x C, C x 4C, 4C x C, then the head's 8320
    ps = int8_gemm.products(LM, 8320)
    assert len(ps) == 32 * 6 + 1 and ps[-1] == (2048, 8320)
    assert sum(k * n for k, n in ps) == 32 * 12 * 2048 ** 2 + 2048 * 8320
    # fewer than 17 rows are padded to 32
    assert int8_gemm.call_bytes(int8_gemm.rows(8), 2048, 2048) == \
        int8_gemm.call_bytes(32, 2048, 2048)


@pytest.mark.parametrize("B,sb,want", [
    (128, 2, 2 * 128 * 32 * 64 * 64 * 2 + 7 * 128 * 32 * 64 * 4),
    (64, 2, 2 * 64 * 32 * 64 * 64 * 2 + 7 * 64 * 32 * 64 * 4),
    (8, 4, 2 * 8 * 32 * 64 * 64 * 4 + 7 * 8 * 32 * 64 * 4),
])
def test_decode_state_bytes_per_bucket(B, sb, want):
    assert wkv_decode.call_bytes(B, 32, 64, sb) == want
    assert wkv_decode.call_bound_s(B, 32, 64, sb) == pytest.approx(
        want / 3.35e12)


def test_vocoder_operations_per_latent():
    # prenet: 1024→384 and 384→1024 projections, 3 embed convs 384→384 k7,
    # 16 ConvNeXt blocks (dw k7, 384→2048, 2048→384)
    prenet = 2 * (2 * 1024 * 384) + 3 * 2 * 384 * 384 * 7 + \
        16 * (2 * 384 * 7 + 2 * 2 * 384 * 2048)
    # wave generator: in conv 1024→1536 k7; per block a transposed conv
    # (2·Ci·Co·k per input latent) and 3 × (k7 + k1) at the block's rate
    wave = 2 * 1024 * 1536 * 7
    wave += 2 * 1536 * 768 * 16 * 1 + 3 * (2 * 768 * 768 * 8) * 8
    wave += 2 * 768 * 384 * 11 * 8 + 3 * (2 * 384 * 384 * 8) * 40
    wave += 2 * 384 * 192 * 8 * 40 + 3 * (2 * 192 * 192 * 8) * 160
    wave += 2 * 192 * 96 * 4 * 160 + 3 * (2 * 96 * 96 * 8) * 320
    wave += 2 * 96 * 7 * 320
    assert model_ops.codec_latent_ops(CODEC) == prenet + wave
    assert 1.1e9 < prenet + wave < 1.25e9


def test_lm_token_operations_by_precision():
    ops = model_ops.lm_token_ops(LM, "int8", 8320)
    C = 2048
    assert ops["int8"] == 32 * 2 * 12 * C * C + 2 * C * 8320
    assert ops["f32"] == 32 * (2 * 2 * C * (64 + 64 + 32) + 10 * C * 64)
    assert ops["bf16"] == 32 * 2 * 2 * C * 128
    bf = model_ops.lm_token_ops(LM, None, 8320)
    assert "int8" not in bf and bf["bf16"] == ops["int8"] + ops["bf16"]
    assert peaks.bound_s(1979e12, 0, "int8") == pytest.approx(1.0)
