"""Build and load the hand-written CUDA kernels under ``himo_tpu_torch/csrc``."""
