"""Hand-written Hopper kernels (sources in aot_tpu_torch/csrc/), each beside
its plain PyTorch version."""
