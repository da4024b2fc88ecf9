"""The port's Hopper kernels against their plain PyTorch versions on the
card. Imports no JAX, so it runs on a CUDA machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

Without a card every test here skips."""
import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401  (fixture)
from semireward_tpu_torch.ops import attention as A
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
    with pytest.raises(NotImplementedError, match="K3"):
        F.fused_mlp(x, w1, b1, w2, b2)             # C = 64 is not built
    with pytest.raises(ValueError, match="bfloat16"):
        F.fused_mlp(x.float(), w1, b1, w2, b2)     # no f32 kernel
    # the model builders' gate asks the same kernel library
    F.require_supported(384, 1536, cuda_device)    # ViT-S
    for c, h in ((768, 3072), (64, 256)):          # ViT-B / BERT-base, C=64
        with pytest.raises(NotImplementedError, match="K3"):
            F.require_supported(c, h, cuda_device)


def _attn_inputs(dev, B, N, H, d, pad, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(B, N, H, d, generator=g).to(dev, torch.bfloat16)
                   for _ in range(4))
    lens = torch.full((B,), N)
    lens[0] = N - pad
    keep = torch.arange(N)[None, :] < lens[:, None]
    bias = torch.where(keep, 0.0, -1e9)[:, None, None, :].to(dev)
    return q, k, v, do, bias


@pytest.mark.cuda
@pytest.mark.parametrize("N", [200, 512, 77, 130])
@pytest.mark.parametrize("bias,rate", [(False, 0.0), (True, 0.0), (True, 0.1)])
def test_flash_kernels_match_plain_on_the_card(cuda_device, N, bias, rate):
    """K2 forward (out, lse) and backward (dq, dk, dv) against the plain
    version on the same bf16 inputs. The kernels round P, dS and P^T to bf16
    before their products: bf16 outputs within 1% of max|plain|; lse (f32)
    within 1e-5 of its magnitude."""
    B, H, d = 2, 3, 64
    q, k, v, do, kb = _attn_inputs(cuda_device, B, N, H, d, pad=37)
    kb = A._key_bias_of(kb, B, H, N) if bias else None
    seed = torch.tensor([1234], dtype=torch.int32, device=cuda_device)
    out, lse = A.kernel_fwd(q, k, v, kb, seed, rate)
    p_out, p_lse = A.plain_fwd(q, k, v, kb, seed, rate)
    delta = A.delta_of(do, out)
    grads = A.kernel_bwd(q, k, v, kb, seed, rate, do, lse, delta)
    p_grads = A.plain_bwd(q, k, v, kb, seed, rate, do, lse, delta)
    torch.cuda.synchronize()
    _close(out.float().cpu().numpy(), p_out.float().cpu().numpy(), 1e-2)
    _close(lse.cpu().numpy(), p_lse.cpu().numpy(), 1e-5)
    for a, b in zip(grads, p_grads):
        _close(a.float().cpu().numpy(), b.float().cpu().numpy(), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [200, 512])
def test_flash_dropout_stream_is_bit_exact_on_the_card(cuda_device, N):
    """The kernel's keep mask read out exactly: q = k = 0 makes every score
    equal; a key bias of -1e9 outside a window of 64 keys leaves p = 1/64
    there and exactly 0 elsewhere; v one-hot per window key puts keep[q, key]
    in output column key - window start. Zero against non-zero is exact, so
    the mask is compared bit for bit with attention_keep_mask."""
    B, H, d = 2, 3, 64
    z = torch.zeros(B, N, H, d, device=cuda_device, dtype=torch.bfloat16)
    seed = torch.tensor([20240601], dtype=torch.int32, device=cuda_device)
    want = A.attention_keep_mask(seed, B * H, N, A.padded_len(N),
                                 A.keep_threshold(0.1)).cpu()
    got = torch.zeros(B * H, N, N, dtype=torch.bool)
    for w in range(0, N, 64):
        width = min(64, N - w)
        v = torch.zeros_like(z)
        v[:, w:w + width, :, :width] = torch.eye(width).to(v)[:, None, :]
        keys = torch.arange(N, device=cuda_device)
        kb = torch.where((keys >= w) & (keys < w + width), 0.0, -1e9)
        kb = kb.expand(B * H, N).contiguous()
        out, _ = A.kernel_fwd(z, z, v, kb, seed, 0.1)
        got[:, :, w:w + width] = (out[..., :width] != 0).permute(
            0, 2, 1, 3).reshape(B * H, N, width).cpu()
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())
    assert abs(want.float().mean().item() - 0.9) < 0.01


@pytest.mark.cuda
def test_flash_autograd_uses_the_kernels(cuda_device):
    """flash_attention on CUDA tensors launches the forward once and the
    backward once, and refuses a bias that is not key-only (no plain
    route on the card)."""
    q, k, v, do, kb = _attn_inputs(cuda_device, 2, 128, 2, 64, pad=9)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    A.reset_launches()
    out = A.flash_attention(q, k, v, bias=kb, dropout_rate=0.1,
                            dropout_seed=torch.tensor(7, device=cuda_device))
    out.backward(do)
    torch.cuda.synchronize()
    assert A.launches == {"flash_attention_fwd": 1, "flash_attention_bwd": 1}
    full = torch.zeros(2, 1, 128, 128, device=cuda_device)
    with pytest.raises(ValueError, match="key-only"):
        A.flash_attention(q, k, v, bias=full)
    assert A.launches["flash_attention_fwd"] == 1
