"""One torch intra-op thread for the port's tests, and OMP_NUM_THREADS=1
for the processes they start.

The tier-1 run puts six pytest workers on the host's cores. Torch's
default pool, a thread a core, in each worker and in each script a test
starts, oversubscribes the cores many times over: a CPU step that takes
milliseconds alone then takes seconds. Each port test file imports the
fixture below (autouse, for its module), which sets one thread while the
module's tests run and restores the count and the environment after.
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    omp = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = omp
