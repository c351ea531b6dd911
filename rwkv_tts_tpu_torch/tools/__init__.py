"""Tools of the port: the kernel-attribution tools, counterparts of the
JAX package's ``tools/profile_stack_kernel.py``,
``tools/profile_step_pieces.py`` and ``tools/profile_prefill_pieces.py``
(each prints one JSON line), the first-contact validator,
``validate_real_assets`` (``tools/validate_real_assets.py``), and the
serving tools in the JAX serving layout (int8 weights, bf16 state):
``soak_serving``, ``probe_stream_latency``, ``profile_buckets`` and
``profile_decode`` (the JAX ``tools/`` of the same names), the LM tools
``profile_first_chunk``, ``profile_int4_b8``, ``profile_fused_ab`` and
``bench_continuous``, the vocoder tools ``profile_vocoder``,
``profile_vocoder_batch`` and ``profile_vocoder_gemm``, and
``profile_tp`` (the JAX ``tools/`` of the same names). Each runs as
``python -m rwkv_tts_tpu_torch.tools.<name>`` on a card, or through its
``main(argv, device="cpu")`` on the CPU."""
