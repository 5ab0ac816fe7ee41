"""The port's llama-3.2-vision-90b against the JAX package, on the CPU:
every `cross_attn_every`-th layer a cross-attention layer over image
embeddings.

The cases are tests/torch_cross_cases.py's (which says what each holds
and to what tolerance), run for this arch.  Regenerate its golden run
with ``JAX_PLATFORMS=cpu PYTHONPATH=src python
tests/test_torch_archs_llama_vision.py``.
"""
import pytest

import torch_arch_parity as P
from torch_cross_cases import (  # noqa: F401 (collected here)
    golden,
    TestBlocks,
    TestCli,
    TestConfig,
    TestForwards,
    TestGolden,
    TestServing,
)
from torch_cross_cases import VLM, cross_golden_reference


@pytest.fixture(scope="module")
def arch():
    return VLM


if __name__ == "__main__":
    P.write_goldens([VLM], cross_golden_reference)
