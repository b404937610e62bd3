"""The port's serving engine on mamba2-780m (attention-free SSD blocks,
recurrent slots) against the JAX package's, on the CPU; the cases are
those of ``recurrent_serving_cases.py``."""
import pytest

from recurrent_serving_cases import *  # noqa: F401,F403
from torch_ranks import _one_torch_thread  # noqa: F401


@pytest.fixture(scope="session")
def arch():
    return "mamba2-780m"
