"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. Raises when CUDA is asked for and no card
    is present: the port never runs on the CPU unless told to.

    On a card it also switches TF32 off for matmuls and convolutions, so
    float32 work stays float32 (cuDNN runs f32 convolutions in TF32 by
    default, which keeps about three decimal digits), and keeps cuDNN to
    deterministic algorithms: its heuristics may otherwise give a
    transposed convolution (the vocoder's upsampling) an algorithm that
    adds with atomics, and a seeded request would not give the same
    audio twice."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
