"""Config system: the JAX package's registry (`aot_tpu.configs`), which
imports no JAX, serves the port as it is; re-exported so that callers of
the port import only aot_tpu_torch."""

from aot_tpu.configs import Config, build_config

__all__ = ["Config", "build_config"]
