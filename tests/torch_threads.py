"""One intra-op torch thread for a port test module.

A test module imports the fixture into its namespace

    from torch_threads import one_torch_thread  # noqa: F401

and every test in it runs its torch calls on one thread.  The suite runs
several pytest-xdist workers on the machine's cores, each with JAX's own
thread pools beside torch's; a torch op that fans out over all the cores
then waits on threads the other workers have descheduled, and the port's
solvers launch many small ops (a check that takes 0.2 s alone took 60 s
in the suite).  No result depends on the thread count beyond summation
order: every comparison keeps its tolerance.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
