"""The port's Hopper kernels against their plain PyTorch versions on the
card. Imports no JAX, so it runs on a CUDA machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

Without a card every test here skips."""
import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401  (fixture)
from semireward_tpu_torch.ops import fused_mlp as F


def _close(got, want, rel):
    scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card(cuda_device):
    """The Hopper kernels against the plain version at a ragged shape
    (bf16: 1e-2 of the largest magnitude; f32 bias grads: 1e-3)."""
    g = torch.Generator().manual_seed(0)
    m, c, h = 100, 128, 256
    x = torch.randn(m, c, generator=g).to(cuda_device, torch.bfloat16)
    w1 = (torch.randn(h, c, generator=g) * 0.05).to(cuda_device, torch.bfloat16)
    b1 = torch.randn(h, generator=g).to(cuda_device)
    w2 = (torch.randn(c, h, generator=g) * 0.05).to(cuda_device, torch.bfloat16)
    b2 = torch.randn(c, generator=g).to(cuda_device)
    gy = torch.randn(m, c, generator=g).to(cuda_device, torch.bfloat16)
    pairs = [(F.kernel_fwd(x, w1, b1, w2, b2), F.plain_fwd(x, w1, b1, w2, b2),
              1e-2)]
    for k, p, name in zip(F.kernel_bwd(x, w1, b1, w2, gy),
                          F.plain_bwd(x, w1, b1, w2, gy),
                          ("dx", "dw1", "dw2", "db1", "db2")):
        pairs.append((k, p, 1e-3 if name.startswith("db") else 1e-2))
    torch.cuda.synchronize()
    for k, p, rel in pairs:
        _close(k.float().cpu().numpy(), p.float().cpu().numpy(), rel)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros(8, 64, device=cuda_device, dtype=torch.bfloat16)
    w1 = torch.zeros(256, 64, device=cuda_device, dtype=torch.bfloat16)
    w2 = torch.zeros(64, 256, device=cuda_device, dtype=torch.bfloat16)
    b1 = torch.zeros(256, device=cuda_device)
    b2 = torch.zeros(64, device=cuda_device)
    with pytest.raises(ValueError, match="C in"):
        F.fused_mlp(x, w1, b1, w2, b2)             # C = 64 is not built
    with pytest.raises(ValueError, match="bfloat16"):
        F.fused_mlp(x.float(), w1, b1, w2, b2)     # no f32 kernel

