"""The port's seamless-m4t-large-v2 against the JAX package, on the CPU:
an encoder-decoder (bidirectional encoder layers, then decoder layers
with self- and cross-attention over the encoder's output).

The cases are tests/torch_cross_cases.py's (which says what each holds
and to what tolerance), run for this arch.  Regenerate its golden run
with ``JAX_PLATFORMS=cpu PYTHONPATH=src python
tests/test_torch_archs_seamless.py``.
"""
import pytest

import torch_arch_parity as P
from torch_cross_cases import (  # noqa: F401 (collected here)
    golden,
    TestBlocks,
    TestCli,
    TestConfig,
    TestEncoder,
    TestForwards,
    TestGolden,
    TestServing,
)
from torch_cross_cases import ENCDEC, cross_golden_reference


@pytest.fixture(scope="module")
def arch():
    return ENCDEC


if __name__ == "__main__":
    P.write_goldens([ENCDEC], cross_golden_reference)
