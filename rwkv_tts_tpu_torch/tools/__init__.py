"""Kernel-attribution tools of the port, the counterparts of the JAX
package's ``tools/profile_stack_kernel.py``, ``tools/profile_step_pieces.py``
and ``tools/profile_prefill_pieces.py``. Each runs as
``python -m rwkv_tts_tpu_torch.tools.<name>`` on a card, or through its
``main(argv, device="cpu")`` on the CPU, and prints one JSON line."""
