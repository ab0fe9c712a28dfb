"""The benchmark of the PyTorch and CUDA port (``caiman_asr_tpu_torch``):
see ``README.md``. Nothing here imports JAX or the JAX package."""
