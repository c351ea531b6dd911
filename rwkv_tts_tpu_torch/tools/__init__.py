"""Tools of the port: the kernel-attribution tools, counterparts of the
JAX package's ``tools/profile_stack_kernel.py``,
``tools/profile_step_pieces.py`` and ``tools/profile_prefill_pieces.py``
(each prints one JSON line), and the first-contact validator,
``validate_real_assets`` (``tools/validate_real_assets.py``). Each runs as
``python -m rwkv_tts_tpu_torch.tools.<name>`` on a card, or through its
``main(argv, device="cpu")`` on the CPU."""
