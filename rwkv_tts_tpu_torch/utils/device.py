"""Device resolution shared by the port's entry points, and the
host-to-card copy that does not wait for the card (``to_card``)."""

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


def to_card(host: torch.Tensor, device) -> torch.Tensor:
    """``host`` copied to ``device`` without waiting for the card.

    CUDA stages a copy from pageable host memory through a buffer of its
    own, and first waits for the work already queued on the stream: a copy
    made while a decode block runs holds the host until that block ends.
    From page-locked ("pinned") memory the copy is queued like a kernel and
    the host goes on, as the JAX engines' transfers do. The copy runs on
    the current stream of ``device``, the stream that then consumes it;
    PyTorch's pinned-memory cache records an event after it and does not
    hand the buffer out again before that event. The values are the same
    either way; to the CPU it is a plain ``Tensor.to``."""
    device = torch.device(device)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)
