"""aot_tpu_torch — the PyTorch / CUDA port of aot_tpu for NVIDIA Hopper.

Mirrors the layout of `aot_tpu/` module for module, so each counterpart sits
at the same relative path. Plain tensor code is PyTorch; every Pallas kernel
of the JAX package on the ported path is a hand-written CUDA kernel under
`csrc/`, built with nvcc at first use (`ops/kernels/_build.py`).

The package imports torch and never jax or flax. It reuses the jax-free
parts of `aot_tpu`: the config registry (`aot_tpu.configs`) and the image
normalisation constants (`aot_tpu.data`).
"""

__version__ = "0.1.0"
