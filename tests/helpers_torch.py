"""Shared set-up of the port's CPU tests.

``one_torch_thread``: import it into a test module (autouse) to run the
module on one intra-op thread. The test run puts several pytest workers on
the machine's cores; torch's OpenMP threads then spin-wait for each other
(a test of small ops took 100x its time alone) and take the cores that the
other workers' JAX tests need. The thread count is restored after the
module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
