"""PyTorch and CUDA port of caiman_asr_tpu for NVIDIA Hopper.

The JAX package ``caiman_asr_tpu`` is the reference this package is held
against; nothing here imports it or JAX. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``.
"""
