"""The port's serving engine on recurrentgemma-2b (RG-LRU blocks and
local attention, hybrid slots: arena rows hold the local layers' rings
beside the recurrent state) against the JAX package's, on the CPU; the
cases are those of ``recurrent_serving_cases.py``."""
import pytest

from recurrent_serving_cases import *  # noqa: F401,F403
from torch_ranks import _one_torch_thread  # noqa: F401


@pytest.fixture(scope="session")
def arch():
    return "recurrentgemma-2b"
