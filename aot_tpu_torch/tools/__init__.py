"""The port's command-line tools, counterparts of the repository's tools/:
`python -m aot_tpu_torch.tools.demo`, `.score` and `.overfit_check`."""
