"""Evaluation: the online per-video inference loop and the J&F scorer."""

from aot_tpu_torch.eval.evaluator import Evaluator, check_supported

__all__ = ["Evaluator", "check_supported"]
