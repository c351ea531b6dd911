"""PyTorch/CUDA port of ``rwkv_tts_tpu`` for one NVIDIA H100.

Property-controlled text → WAV: tokenizer + property tokens → RWKV-7
prefill → 32 global tokens → semantic tokens until EOS → BiCodec
detokenize → 16 kHz waveform (``runtime.pipeline.TtsPipeline``). The
decode and prefill WKV-7 recurrences run as CUDA C++ kernels written for
``sm_90a`` (``csrc/``, built at first use by ``ops/_build.py``); the rest
is plain PyTorch.

The port imports nothing of JAX or of ``rwkv_tts_tpu``: the JAX package is
its reference, and only the tests import both. Importing this package
builds nothing and needs neither ``nvcc`` nor a card. Entry points take
``device=None``, meaning ``"cuda"``; they raise when no card is present
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
