"""Shared helpers of the tests/test_torch_*.py files (the PyTorch port held
against the JAX package)."""
import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The first CUDA card; tests marked ``cuda`` skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda", 0)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.is_floating_point() \
            else x.detach().cpu().numpy()
    return np.asarray(x)


def assert_rel_close(got, want, rel, what=""):
    """max|got - want| <= rel * max|want| (elementwise over the array)."""
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale + 1e-12,
                               err_msg=what)
