"""The port's fused MLP (semireward_tpu_torch/ops/fused_mlp.py) against the
JAX Pallas kernels run in interpret mode (as tests/test_fused_mlp.py runs
them), forward and all five gradients, with a ragged last row block: the
full-resident pair and the hidden-blocked one (``block_h`` < H, the form
that C = 768 takes). Both run the port's one plain version on the CPU; the
blocked JAX kernels sum per hidden slice, so their f32 sums run in yet
another order, within the same tolerances.

On the CPU the port runs its plain PyTorch version, which does the kernel's
arithmetic. Tolerances: in float32 both sides compute the same f32 products
and sums in another order, and GELU's erf differs by <= 1.5e-7 (the TPU
kernel's A&S approximation): 1e-5 of the largest magnitude. In bfloat16 the
outputs and dW are rounded to 8 significant bits after sums taken in another
order: 2e-2 of the largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semireward_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from semireward_tpu_torch.ops import fused_mlp as F

M, C, H = 40, 64, 256  # block_m=16 on the JAX side: 3 blocks, last partial


def _inputs():
    rs = np.random.RandomState(0)
    return (rs.randn(M, C).astype(np.float32),
            (rs.randn(C, H) * 0.05).astype(np.float32),
            (rs.randn(H) * 0.1).astype(np.float32),
            (rs.randn(H, C) * 0.05).astype(np.float32),
            (rs.randn(C) * 0.1).astype(np.float32),
            rs.randn(M, C).astype(np.float32))


def _close(got, want, rel):
    scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("block_h", [None, 64])
@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_forward_and_grads_match_jax(dtype, rel, block_h):
    x, w1, b1, w2, b2, coef = _inputs()
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16

    def jloss(x32, w1, b1, w2, b2):
        out = jax_fused_mlp(x32.astype(jdt), w1, b1, w2, b2, block_m=16,
                            block_h=block_h, interpret=True)
        return (out.astype(jnp.float32) * coef).sum(), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                           has_aux=True)(
        *(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))

    # the port takes torch.nn.Linear layouts: w1 [H, C], w2 [C, H]
    tx, tw1, tb1, tw2, tb2 = (torch.tensor(a, requires_grad=True) for a in
                              (x, w1.T.copy(), b1, w2.T.copy(), b2))
    tout = F.fused_mlp(tx.to(tdt), tw1, tb1, tw2, tb2, block_h=block_h)
    (tout.float() * torch.from_numpy(coef)).sum().backward()

    _close(tout.float().detach().numpy(),
           np.asarray(jout.astype(jnp.float32)), rel)
    jdx, jdw1, jdb1, jdw2, jdb2 = (np.asarray(g, np.float32) for g in jgrads)
    _close(tx.grad.numpy(), jdx, rel)
    _close(tw1.grad.numpy().T, jdw1, rel)
    _close(tb1.grad.numpy(), jdb1, rel)
    _close(tw2.grad.numpy().T, jdw2, rel)
    _close(tb2.grad.numpy(), jdb2, rel)


def test_plain_bwd_is_autograd_of_plain_fwd_in_f32():
    """The hand-written backward is the gradient of the forward."""
    x, w1, b1, w2, b2, g = (torch.from_numpy(a) for a in _inputs())
    w1, w2 = w1.T.contiguous(), w2.T.contiguous()
    args = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    F.plain_fwd(*args).backward(g)
    dx, dw1, dw2, db1, db2 = F.plain_bwd(x, w1, b1, w2, g)
    for got, a in zip((dx, dw1, db1, dw2, db2), args):
        torch.testing.assert_close(got, a.grad, rtol=1e-5, atol=1e-5)


def test_rejects_devices_without_a_path():
    x = torch.empty(4, C, device="meta")
    with pytest.raises(ValueError, match="no path"):
        F.fused_mlp(x, torch.empty(H, C), torch.empty(H), torch.empty(C, H),
                    torch.empty(C))


def test_block_h_must_divide_the_hidden_dim_as_in_jax():
    """The JAX call contract: a block_h that does not divide H raises
    ValueError in both packages (the TPU grid would drop the last partial
    hidden block)."""
    x, w1, b1, w2, b2, _ = _inputs()
    with pytest.raises(ValueError, match="must divide"):
        jax_fused_mlp(jnp.asarray(x), w1, b1, w2, b2, block_h=96,
                      interpret=True)
    with pytest.raises(ValueError, match="must divide"):
        F.fused_mlp(torch.from_numpy(x), torch.from_numpy(w1.T.copy()),
                    torch.from_numpy(b1), torch.from_numpy(w2.T.copy()),
                    torch.from_numpy(b2), block_h=96)


def _check_plan_covers_every_tile_once(m, c, h, kernel):
    """In each GEMM of the plan every output tile comes once per K split,
    the splits cut K into non-empty consecutive ranges, and the persistent
    walk (CTA b takes b, b + grid, ...) visits every tile once."""
    sms = 132
    plan = F.blocked_plan(m, c, h, sms, kernel=kernel)
    for name, (outputs, k, widths, *_) in \
            F._blocked_products(m, c, h, kernel).items():
        bn, splits = plan[name]["bn"], plan[name]["splits"]
        assert bn in widths, (name, bn)
        tiles = F.blocked_tiles(outputs, k, bn, splits)
        assert plan[name]["tiles"] == len(tiles)
        assert plan[name]["grid"] == min(len(tiles), sms)
        want = sorted((s, o, r, col) for s in range(splits)
                      for o, (rows, cols) in enumerate(outputs)
                      for r in range(0, rows, F.GEMM_BM)
                      for col in range(0, cols, bn))
        assert sorted(t[:4] for t in tiles) == want, name
        ranges = sorted({(s, kb, ke) for s, _, _, _, kb, ke in tiles})
        assert [r[0] for r in ranges] == list(range(splits))
        assert ranges[0][1] == 0 and ranges[-1][2] == -(-k // F.GEMM_BK)
        assert all(kb < ke for _, kb, ke in ranges), name
        assert all(a[2] == b[1] for a, b in zip(ranges, ranges[1:]))
        grid = plan[name]["grid"]
        walk = sorted(t for b in range(grid)
                      for t in range(b, len(tiles), grid))
        assert walk == list(range(len(tiles)))
    ws = plan["workspace"]
    assert ws["h"] == ws["dh"] == m * h
    assert ws["db1"] == -(-m // F.GEMM_BM) * h and ws["db2"] == -(-m // 32) * c
    assert ws["dw"] == (0 if plan["dw"]["splits"] == 1
                        else 2 * c * h * plan["dw"]["splits"])
    return plan


@pytest.mark.parametrize("m", [4776, 6144, 8192, 1, 129])
def test_blocked_plan_covers_every_tile_once(m):
    """K3's launch plan at the HuBERT (M 24*199), BERT (12*512) and BERT
    eval (16*512) shapes and small ragged M."""
    _check_plan_covers_every_tile_once(m, 768, 3072, "blocked")


@pytest.mark.parametrize("m,c,h", [(12336, 1024, 4096), (1, 1024, 4096),
                                   (129, 1024, 4096), (4112, 1024, 4096),
                                   (2749, 512, 2048), (100, 448, 1792),
                                   (100, 64, 256)])
def test_blocked_plan_covers_every_tile_once_at_every_width(m, c, h):
    """K3's launch plan at the widths it takes besides 768: DINOv2
    ViT-L/14's (C 1024, H 4096) at its train shape (16 + 16 images with
    ``use_cat``: 48 * 257 = 12336 rows), its eval batch (16 * 257), small
    ragged M, and C 512, 448 (a half-empty 256-wide column tile) and 64;
    every forced tile width and B3 split at C 1024 is valid and covers
    every tile once too."""
    _check_plan_covers_every_tile_once(m, c, h, "blocked")
    if (m, c) == (12336, 1024):
        for bn in (128, 256):
            for splits in range(1, F.GEMM_MAX_SPLITS + 1):
                plan = F.blocked_plan(m, c, h, 132, bn=bn, dw_splits=splits)
                assert plan["dw"]["splits"] == splits
                assert plan["workspace"]["dw"] == (
                    0 if splits == 1 else 2 * c * h * splits)
                for name, (outputs, k, *_) in \
                        F._blocked_products(m, c, h).items():
                    tiles = F.blocked_tiles(outputs, k, plan[name]["bn"],
                                            plan[name]["splits"])
                    assert plan[name]["tiles"] == len(tiles)
                    assert len(set(t[:4] for t in tiles)) == len(tiles)


@pytest.mark.parametrize("m,c,h", [(6168, 384, 1536), (4112, 384, 1536),
                                   (1, 384, 1536), (129, 384, 1536),
                                   (6168, 192, 768)])
def test_full_plan_covers_every_tile_once(m, c, h):
    """K1's launch plan at the ViT-S train (M 24*257) and eval (16*257)
    shapes, small ragged M and ViT-Ti's width, from K1's own tile widths
    (F1 128, B1 64). At the ViT-S train shape the 192-wide tile gives F2 and
    B2 one wave of 98 tiles (74% of 132 SMs) where 128 needs 1.11 waves (147
    tiles) and 256 leaves a half-empty column tile."""
    plan = _check_plan_covers_every_tile_once(m, c, h, "full")
    assert plan["up"]["bn"] == 128 and plan["dh"]["bn"] == 64
    if (m, c) == (6168, 384):
        assert [plan[n]["bn"] for n in ("down", "dx")] == [192] * 2
        assert plan["up"]["tiles"] == 588 and plan["down"]["tiles"] == 98


def test_blocked_plan_forces_widths_and_splits():
    """The card tests reach every tile width and B3's K splits through
    blocked_plan's forcing arguments; a split count past K raises."""
    plan = F.blocked_plan(300, 768, 3072, 132, bn=256, dw_splits=3)
    assert [plan[n]["bn"] for n in ("up", "down", "dh", "dx", "dw")] == \
        [256, 256, 128, 256, 256]
    assert plan["dw"]["splits"] == 3
    assert plan["workspace"]["dw"] == 3 * 2 * 768 * 3072
    with pytest.raises(ValueError, match="K splits"):
        F.blocked_plan(64, 768, 3072, 132, dw_splits=2)
    with pytest.raises(ValueError, match="positive"):
        F.blocked_plan(0, 768, 3072, 132)


@pytest.mark.parametrize("bn,splits,want", [
    (128, 1, [128, 128, 64, 128, 128]),
    (192, 2, [128, 192, 64, 192, 192]),
    (256, 4, [128, 256, 64, 256, 256])])
def test_full_plan_forces_widths_and_splits(bn, splits, want):
    """K1's plan honours a forced tile width on every GEMM whose widths hold
    it and a forced B3 split; F1 is 128 and B1 64 wide whatever is
    forced."""
    plan = F.blocked_plan(300, 384, 1536, 132, bn=bn, dw_splits=splits,
                          kernel="full")
    got = [plan[n]["bn"] for n in ("up", "down", "dh", "dx", "dw")]
    assert got == want
    assert plan["dw"]["splits"] == splits
    assert plan["workspace"]["dw"] == (0 if splits == 1
                                       else splits * 2 * 384 * 1536)
    with pytest.raises(ValueError, match="K splits"):
        F.blocked_plan(129, 384, 1536, 132, dw_splits=4, kernel="full")


def test_build_target_hashes_the_headers(tmp_path, monkeypatch):
    """A library's file name carries the hash of its source and of every
    csrc/*.cuh, so an edit to the shared GEMM header never loads a stale
    build of either fused-MLP kernel."""
    import shutil

    from semireward_tpu_torch.ops import _build

    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._target(n) for n in ("fused_mlp", "fused_mlp_blocked")}
    assert before == {n: _build._target(n) for n in before}  # stable
    header = tmp_path / "hopper_gemm.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._target(n) for n in before}
    assert all(after[n] != before[n] for n in before)
    assert all(after[n].name.startswith(n + "-") for n in before)


def test_profile_groups_the_k3_kernels_by_name():
    """profile_step files K1's and K3's wgmma GEMMs under their fused-MLP
    rows, not under cuBLAS's GEMMs."""
    from semireward_tpu_torch.profile_step import _group

    ns = "void (anonymous namespace)::"
    for kernel, group in (("k3_fwd_up_kernel<256>", "fused_mlp_blocked_fwd"),
                          ("k3_fwd_down_kernel<128>", "fused_mlp_blocked_fwd"),
                          ("k3_bwd_dh_kernel<128>", "fused_mlp_blocked_bwd"),
                          ("k3_bwd_dw_kernel<256>", "fused_mlp_blocked_bwd"),
                          ("k3_bwd_dx_kernel<128>", "fused_mlp_blocked_bwd"),
                          ("k3_bwd_reduce_kernel", "fused_mlp_blocked_bwd"),
                          ("k1_fwd_up_kernel<128>", "fused_mlp_fwd"),
                          ("k1_fwd_down_kernel<256>", "fused_mlp_fwd"),
                          ("k1_bwd_dh_kernel<64>", "fused_mlp_bwd"),
                          ("k1_bwd_dx_kernel<192>", "fused_mlp_bwd"),
                          ("k1_bwd_dw_kernel<128>", "fused_mlp_bwd"),
                          ("k1_bwd_reduce_kernel", "fused_mlp_bwd")):
        assert _group(ns + kernel + "(...)") == group, kernel
    assert _group("(anonymous namespace)::k3_bwd_colsum_kernel(...)") == \
        "fused_mlp_blocked_bwd"
    assert _group("(anonymous namespace)::k1_bwd_colsum_kernel(...)") == \
        "fused_mlp_bwd"
    assert _group("sm90_xmma_gemm_bf16bf16_bf16f32").startswith("gemm")
