"""Training (port of aot_tpu/train): the optimizer, EMA, the train step and
the Trainer. `python -m aot_tpu_torch.train` is the CLI."""
