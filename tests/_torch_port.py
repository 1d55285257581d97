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



def mamba2_scan_ref64(x, dt, A, Bm, Cm):
    """The reference's sequential oracle for the SSD scan
    (``repro/kernels/mamba2_scan/ref.py``) in numpy float64, with its final
    state: x [BH, S, P]; dt [BH, S]; A [BH]; Bm/Cm [BH, S, N].  Returns
    (y [BH, S, P], state [BH, N, P]); independent of the port's code."""
    x, dt, A, Bm, Cm = (np.asarray(a, np.float64) for a in (x, dt, A, Bm, Cm))
    BH, S, P = x.shape
    state = np.zeros((BH, Bm.shape[-1], P))
    y = np.empty((BH, S, P))
    for t in range(S):
        state = state * np.exp(dt[:, t] * A)[:, None, None] \
            + (dt[:, t, None] * Bm[:, t])[:, :, None] * x[:, t, None, :]
        y[:, t] = np.einsum("bn,bnp->bp", Cm[:, t], state)
    return y, state


def assert_close_beside_the_reference(port, ref, exact, dtype="float32",
                                      slack=1.5):
    """For a case where the reference kernel ``ref`` itself is farther than
    the tolerance from the ``exact`` result (``mamba2_scan_ref64``): fp32
    sums of thousands of terms, as at N 128 and a chunk of 256, where
    outputs reach 150 and the Pallas kernel strays 4.5e-4.  With E the
    reference's largest |ref - exact|, the port must be within the
    tolerance plus ``slack`` E of the exact result (its sums run in
    another order; the largest ratio measured was 1.35), and within the
    tolerance plus (1 + slack) E of the reference kernel, elementwise,
    with the tolerance's relative part as in ``assert_close``."""
    t = tol(dtype)
    port, ref, exact = (np.asarray(a, np.float64) for a in (port, ref, exact))
    E = float(np.max(np.abs(ref - exact)))
    np.testing.assert_allclose(port, exact, atol=t + slack * E, rtol=t)
    np.testing.assert_allclose(port, ref, atol=t + (1 + slack) * E, rtol=t)
