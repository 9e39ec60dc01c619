"""aot_tpu_torch — the PyTorch / CUDA port of aot_tpu for NVIDIA Hopper.

Mirrors the layout of `aot_tpu/` module for module, so each counterpart sits
at the same relative path. Plain tensor code is PyTorch; every Pallas kernel
of the JAX package on the ported path is a hand-written CUDA kernel under
`csrc/`, built with nvcc at first use (`ops/kernels/_build.py`).

The package imports torch and never jax, flax or anything of `aot_tpu`:
the JAX-free modules it needs (the config registry, the data pipeline, the
C++ augmentation library, the J&F scorer, mask IO) are its own copies.
Its entry points run on cuda:0 unless the caller asks for the CPU
(`utils/device.py`).
"""

__version__ = "0.1.0"
