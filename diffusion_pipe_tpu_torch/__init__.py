"""diffusion_pipe_tpu_torch: the PyTorch/CUDA port of diffusion_pipe_tpu.

Module names mirror the JAX package (`diffusion_pipe_tpu`), which stays the
reference. This package imports torch and numpy, never JAX. Its attention
runs on hand-written Hopper kernels (csrc/, built with nvcc at first use);
entry points run on CUDA unless the caller passes device="cpu", where the
kernels' plain PyTorch versions run instead.
"""

__version__ = "0.1.0"
