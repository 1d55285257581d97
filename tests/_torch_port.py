"""Shared pieces of the port's differential tests (tests/test_torch_*.py):
the reference tolerance and a fixture that runs torch single-threaded
(the suite runs several test processes at once, and torch's small CPU
ops only lose time to thread hand-offs)."""
import numpy as np
import pytest
import torch


def tol(dtype) -> float:
    """The reference's kernel tolerance (tests/test_kernels.py:_tol)."""
    return 2e-2 if "bfloat16" in str(dtype) else 2e-5


def assert_close(port, ref, dtype="float32"):
    t = tol(dtype)
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), atol=t, rtol=t)


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
