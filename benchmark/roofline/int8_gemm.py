"""The int8 weight products of one RWKV-7 decode step (``ops/quant``'s
``torch._int_mm`` path): int8 activations [M, K] by int8 weights [K, N]
into int32 [M, N], each input byte read once and the output written once.
"""

from . import peaks

# substrings that mark the library's int8 GEMM kernels by name (cuBLASLt's
# and CUTLASS's IMMA/WMMA kernels on s8 operands)
NAME_MARKS = ("i8", "s8", "int8", "imma")


def is_kernel(name: str) -> bool:
    n = name.lower()
    return ("gemm" in n or "cutlass" in n or "wmma" in n) and \
        any(m in n for m in NAME_MARKS)


def products(lm: dict, head_cols: int):
    """(K, N) of the step's products in launch order: per layer w_r, w_k,
    w_v, w_o, ffn_k, ffn_v, then the head's first ``head_cols`` columns."""
    C, F = lm["n_embd"], lm["ffn_mult"] * lm["n_embd"]
    layer = [(C, C)] * 4 + [(C, F), (F, C)]
    return layer * lm["n_layer"] + [(C, head_cols)]


def rows(M: int) -> int:
    """The rows the library multiplies: ``torch._int_mm`` needs more than
    16, so the port pads smaller M to 32."""
    return 32 if M <= 16 else M


def call_bytes(M: int, K: int, N: int) -> int:
    return K * N + M * K + 4 * M * N


def call_ops(M: int, K: int, N: int) -> int:
    return 2 * M * K * N


def call_bound_s(M: int, K: int, N: int) -> float:
    m = rows(M)
    return peaks.bound_s(call_ops(m, K, N), call_bytes(m, K, N), "int8")


def mean_call_bound_s(M: int, lm: dict, head_cols: int) -> float:
    """The bound of one product averaged over a step's products."""
    ps = products(lm, head_cols)
    return sum(call_bound_s(M, K, N) for K, N in ps) / len(ps)
