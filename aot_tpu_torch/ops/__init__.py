"""Tensor ops: attention, position embeddings, image resizes, kernels."""
