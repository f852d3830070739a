"""The port's test files hold torch to one intra-op thread for their run.

Each port test file imports ``one_torch_thread``, an autouse fixture of the
file's scope: under the tier-1 run's six workers torch's default thread
count oversubscribed the cores the workers share, which made the port's
files several times slower than alone."""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the file's tests; the count before, after."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


def test_a_file_runs_on_one_thread():
    assert torch.get_num_threads() == 1
