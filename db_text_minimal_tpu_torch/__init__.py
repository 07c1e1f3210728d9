"""DBNet text detection in PyTorch and CUDA for NVIDIA Hopper.

The port of ``db_text_minimal_tpu`` (JAX on a TPU), which stays beside it as
the reference. It imports neither JAX nor the JAX package. Entry points run
on CUDA unless the caller passes ``device="cpu"``.
"""
