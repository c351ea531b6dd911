"""PyTorch/CUDA port of ``rwkv_tts_tpu`` for one NVIDIA H100.

``runtime.pipeline.TtsPipeline`` runs text → WAV: tokenizer + property
tokens, or a cloned voice's 32 global tokens → RWKV-7 prefill → global
tokens (property mode) → semantic tokens until EOS → BiCodec detokenize →
16 kHz waveform. A voice is cloned from a reference WAV (host front end,
then wav2vec2 features and BiCodec encode) or taken from the ``.raf``
voice store. ``TtsPipeline.from_checkpoints`` loads the model files
(``models/convert``, ``prefab``, ``codec_loader``; the codecs' exported
graphs run on ``models/onnx_graph``). The WKV-7 recurrences (decode,
sequential prefill, WY chunked prefill) run as CUDA C++ kernels written
for ``sm_90a`` (``csrc/``, built at first use by ``ops/_build.py``); the
rest is plain PyTorch.

The port imports nothing of JAX or of ``rwkv_tts_tpu``: the JAX package is
its reference, and only the tests import both. Importing this package
builds nothing and needs neither ``nvcc`` nor a card. Entry points take
``device=None``, meaning ``"cuda"``; they raise when no card is present
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
