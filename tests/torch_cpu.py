"""A module fixture for the port's 3DGS trainer tests on the CPU."""

import sys

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def lean_cpu():
    """Runners mirror their scalars into tensorboard where it imports, which
    pulls in TensorFlow where installed (~15 s); their JSONL logs are enough
    in tests.  torch runs one intra-op thread: the ops here are small, and
    beside the suite's other workers torch's thread team spins (the CLI's
    60 trajectory frames took 255 s instead of 2)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield
    torch.set_num_threads(threads)
