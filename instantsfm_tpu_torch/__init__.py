"""PyTorch/CUDA port of InstantSfM-TPU.

Mirrors the paths and names of ``instantsfm_tpu`` (the JAX reference) module
by module; see README.md "PyTorch/CUDA port".  Entry points run on the CUDA
card unless the caller passes ``device="cpu"``.
"""
