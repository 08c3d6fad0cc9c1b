"""Shared fixture of the PyTorch port's test modules: PyTorch runs its
CPU ops on one thread while a module's tests run, and gets its thread
count back afterwards. The tests use small shapes, and under ``pytest
-n 6`` each worker's default pool (one thread per core) would only
compete for the cores with the JAX tests running in the other workers.
Import it into a test module to apply it there."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
