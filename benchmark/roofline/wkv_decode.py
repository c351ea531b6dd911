"""The in-place WKV decode kernel (``csrc/wkv7_decode.cu``), one call a
layer and step: per slot and head it reads and writes the N × N state
(in the state's storage type) and reads r, w, k, v, a, b and writes y
(float32, N each)."""

from . import peaks

NAME = "wkv7_decode_kernel"


def is_kernel(name: str) -> bool:
    return NAME in name


def call_bytes(B: int, H: int, N: int, state_bytes: int) -> int:
    return 2 * B * H * N * N * state_bytes + 7 * B * H * N * 4


def call_ops(B: int, H: int, N: int) -> int:
    """Per state element: decay, the a-row product and its add, the b and
    v·k rank-one updates (8 operations), and the read-out's multiply-add."""
    return 10 * B * H * N * N


def call_bound_s(B: int, H: int, N: int, state_bytes: int) -> float:
    return peaks.bound_s(call_ops(B, H, N), call_bytes(B, H, N, state_bytes),
                         "f32")
