"""``one_thread``: a module fixture that runs a port test file's torch work
on one intra-op thread and restores the count after.  The test workers
share the machine's cores, and torch's default of one thread a core then
makes each of many small CPU ops wait on threads that have no core (the
router and utils files took 100 s instead of 16 s beside four workers
running the JAX package's tests)."""

import pytest
import torch


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
