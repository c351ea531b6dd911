"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit). A share of a roofline or of a peak is stated
against these, with the card's power limit beside the reading."""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {
    "int8": 1979e12,
    "fp8": 1979e12,
    "bf16": 989e12,
    "tf32": 495e12,
    "f32": 67e12,      # outside the tensor cores: the port runs TF32 off
}


def bound_s(ops: float, nbytes: float, precision: str) -> float:
    """The least time the chip could take: the larger of the operations
    at the precision's peak and the bytes at HBM bandwidth."""
    return max(ops / OPS_PER_S[precision], nbytes / HBM_BYTES_PER_S)
