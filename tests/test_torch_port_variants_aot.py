"""The MobileNetV2 AOT variants that no other port test runs (AOTS, AOTB,
AOTL: two and three LSTT blocks with the intermediate decoder norms)
against aot_tpu's online engine on the CPU, with the same seeded
weights: the reference frame and 2 propagated frames at 257x257 (a 17x17
grid, as tests/test_torch_port_model.py and _deaot.py use), LT gap 1, so
the second step reads two LT frames. Gates of
tests/test_torch_port_engine.py: grid logits within 1e-3, masks agree on
>= 99.9%."""

import pytest

from test_torch_port_encoders import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_variants import check_variant_engine


@pytest.mark.parametrize("variant", ["aots", "aotb", "aotl"])
def test_variant_matches_jax_engine(variant):
    check_variant_engine(variant)
