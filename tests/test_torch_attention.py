"""K2, flash attention: the port (``semireward_tpu_torch/ops/attention.py``)
against the JAX package's Pallas kernels, run in interpret mode on the CPU
(``flash_attention(..., interpret=True, force=True)``), on the same inputs.

- The dropout keep mask is bit-equal to ``attention_keep_mask``, at a ragged
  N (Np = 256 for N = 200) and with ``bh_offset`` / ``local_heads``; so is
  the mask packed into the kernels' keep words (``pack_keep_bits``) and
  unpacked again.
- The plain forward and the gradients through the port's autograd Function
  (its plain backward on the CPU) match ``jax.vjp`` of the interpret-mode
  kernels: f32 inputs within 1e-5 of max|JAX| (f32 sums in another order);
  bf16 inputs within 1% of max|JAX| (one bf16 rounding of the output, 0.4%,
  with room for the order of the f32 sums before it).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_rel_close
from semireward_tpu.ops import attention as JA
from semireward_tpu_torch.ops import attention as TA

B, H, D = 2, 2, 64


_MASK_CASES = [
    (1234, 4, 200, 0.1, 0, None, None),       # ragged: Np = 256
    (77, 6, 128, 0.1, 10, None, None),        # bh_offset
    (-5, 8, 136, 0.3, 4, 2, 6),               # head-sharded decomposition
    (2 ** 31 - 1, 3, 64, 0.5, 0, 3, None),    # local_heads, default stride
    (9, 3, 120, 0.1, 2 ** 18 - 1, None, None),  # counter wraps past 2**32
]


@functools.lru_cache(maxsize=None)
def _jax_keep_mask(seed, BH, N, rate, off, hl, st):
    """The JAX package's keep mask of one case (numpy bool [BH, N, N]),
    computed once for the tests that read it."""
    np_pad = JA._BQ * -(-N // JA._BQ)
    return np.asarray(jax.jit(lambda s, o: JA.attention_keep_mask(
        s, BH, N, np_pad, JA.keep_threshold(rate), bh_offset=o,
        local_heads=hl, head_stride=st))(seed, off))


@pytest.mark.parametrize("seed,BH,N,rate,off,hl,st", _MASK_CASES)
def test_keep_mask_is_bit_equal(seed, BH, N, rate, off, hl, st):
    np_pad = JA._BQ * -(-N // JA._BQ)
    assert TA.padded_len(N) == np_pad
    thresh = JA.keep_threshold(rate)
    assert TA.keep_threshold(rate) == thresh
    want = _jax_keep_mask(seed, BH, N, rate, off, hl, st)
    got = TA.attention_keep_mask(torch.tensor(seed, dtype=torch.int32), BH,
                                 N, np_pad, thresh, bh_offset=off,
                                 local_heads=hl, head_stride=st)
    np.testing.assert_array_equal(got.numpy(), want)
    assert abs(want.mean() - (1.0 - rate)) < 0.01


@pytest.mark.parametrize("seed,BH,N,rate,off,hl,st", _MASK_CASES)
def test_packed_keep_bits_are_bit_equal(seed, BH, N, rate, off, hl, st):
    """pack_keep_bits: [BH, N, Np / 32] int32 words, bit k % 32 of word
    k // 32 is keep[q, k], the bits of keys >= N are 0; unpacked, the port's
    mask equals the JAX package's attention_keep_mask bit for bit."""
    np_pad = TA.padded_len(N)
    want = _jax_keep_mask(seed, BH, N, rate, off, hl, st)
    bits = TA.pack_keep_bits(TA.attention_keep_mask(
        torch.tensor(seed, dtype=torch.int32), BH, N, np_pad,
        TA.keep_threshold(rate), bh_offset=off, local_heads=hl,
        head_stride=st))
    assert bits.dtype == torch.int32 and bits.shape == (BH, N, np_pad // 32)
    words = bits.numpy().view(np.uint32)
    unpacked = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    unpacked = unpacked.reshape(BH, N, np_pad).astype(bool)
    np.testing.assert_array_equal(unpacked[..., :N], want)
    assert not unpacked[..., N:].any()


def _inputs(N, dtype, seed=0):
    rs = np.random.RandomState(seed + N)
    q, k, v, do = (rs.randn(B, N, H, D).astype(np.float32) for _ in range(4))
    lens = np.array([N - 37, N])
    mask = np.arange(N)[None, :] < lens[:, None]
    bias = np.where(mask, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    if dtype == "bfloat16":  # the same bf16 values on both sides
        q, k, v, do = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                       for x in (q, k, v, do))
    return q, k, v, do, bias


def _jax_run(q, k, v, do, dtype, **kw):
    jdt = getattr(jnp, dtype)

    def f(q, k, v):
        return JA.flash_attention(q, k, v, interpret=True, force=True, **kw)

    @jax.jit    # one compiled program instead of eager kernel grid steps
    def run(q, k, v, do):
        out, vjp = jax.vjp(f, q, k, v)
        return (out,) + vjp(do)

    return run(*(jnp.asarray(x, jdt) for x in (q, k, v, do)))


def _torch_run(q, k, v, do, dtype, **kw):
    tdt = getattr(torch, dtype)
    args = [torch.tensor(x).to(tdt).requires_grad_() for x in (q, k, v)]
    out = TA.flash_attention(*args, **kw)
    out.backward(torch.tensor(do).to(tdt))
    return (out,) + tuple(a.grad for a in args)


@pytest.mark.parametrize("N", [128, 200])
@pytest.mark.parametrize("mode", ["plain", "bias", "bias_dropout"])
def test_forward_and_grads_match_jax(N, mode):
    _check_against_jax(N, mode, "float32", 1e-5)


def test_bf16_forward_and_grads_match_jax():
    _check_against_jax(200, "bias_dropout", "bfloat16", 1e-2)


def _check_against_jax(N, mode, dtype, rel):
    q, k, v, do, bias = _inputs(N, dtype)
    jkw, tkw = {}, {}
    if mode != "plain":
        jkw["bias"], tkw["bias"] = jnp.asarray(bias), torch.tensor(bias)
    if mode == "bias_dropout":
        jkw.update(dropout_rate=0.1, dropout_seed=99)
        tkw.update(dropout_rate=0.1,
                   dropout_seed=torch.tensor([99], dtype=torch.int32))
    TA.reset_launches()
    got = _torch_run(q, k, v, do, dtype, **tkw)
    want = _jax_run(q, k, v, do, dtype, **jkw)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == getattr(torch, dtype), name
        assert_rel_close(a, np.asarray(b, np.float32), rel, f"{mode} {name}")
    # the CPU runs the plain version: no kernel launch
    assert TA.launches == {"flash_attention_fwd": 0, "flash_attention_bwd": 0}


def test_plain_lse_matches_the_jax_kernel():
    """lse (saved for the backward) against the JAX forward kernel's."""
    q, k, v, _, bias = _inputs(200, "float32")
    qp, kp, vp = (jnp.asarray(JA._pad_to(JA._pad_to(
        jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, 200, D), 256, 1),
        128, 2)) for x in (q, k, v))
    kb = JA._pad_to(JA._key_bias_of(jnp.asarray(bias), B, H, 200), 256, 2)
    _, jlse = JA._fwd_call(qp, kp, vp, kb, jnp.zeros((1, 4), jnp.int32),
                           D ** -0.5, 200, True, 0, 1.0, interpret=True)
    _, lse = TA.plain_fwd(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          TA._key_bias_of(torch.tensor(bias), B, H, 200))
    assert_rel_close(lse, np.asarray(jlse)[:, 0, :200], 1e-6, "lse")


@pytest.mark.parametrize("shape", [(1, 1, 130, 130), (1, 130), (2, 2, 1, 129)])
def test_non_key_bias_is_refused(shape):
    """A bias that is not a key-only broadcast [B|1, H|1, 1, N] is refused
    on every device: no net of the port passes one, and the kernels read
    one bias row per batch*head."""
    q = torch.zeros(2, 130, 2, 32)
    with pytest.raises(ValueError, match="key-only"):
        TA.flash_attention(q, q, q, bias=torch.zeros(shape))


def test_seed_rules():
    x = torch.randn(1, 16, 1, 32)
    with pytest.raises(ValueError, match="dropout_seed"):
        TA.flash_attention(x, x, x, dropout_rate=0.1)
    a = TA.flash_attention(x, x, x, dropout_rate=0.1, dropout_seed=42)
    b = TA.flash_attention(x, x, x, dropout_rate=0.1,
                           dropout_seed=torch.tensor(42, dtype=torch.int32))
    c = TA.flash_attention(x, x, x, dropout_rate=0.1, dropout_seed=43)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel entry points never run on a CPU tensor; only the autograd
    Function picks the plain version, by the tensor's device."""
    x = torch.zeros(1, 64, 1, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="expected CUDA"):
        TA.kernel_fwd(x, x, x)
    lse = torch.zeros(1, 64)
    bits = torch.zeros(1, 64, 4, dtype=torch.int32)
    seed = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError, match="expected CUDA"):
        TA.kernel_bwd(x, x, x, None, None, 0.0, x, lse, x, None)
    with pytest.raises(ValueError, match="expected CUDA"):
        TA.kernel_bwd(x, x, x, None, seed, 0.1, x, lse, x, bits)
    with pytest.raises(ValueError, match="expected CUDA"):
        TA.kernel_fwd(x, x, x, None, seed, 0.1, keep_bits=True)


def test_profile_groups_the_k2_kernels_by_name():
    """profile_step files K2's forward and its dq and dk/dv kernels under
    the flash attention rows, not under "other" or cuBLAS's GEMMs."""
    from semireward_tpu_torch.profile_step import _group

    for name, group in (
            ("(anonymous namespace)::k2_fwd_kernel"
             "((anonymous namespace)::FlashArgs)", "flash_attention_fwd"),
            ("(anonymous namespace)::k2_bwd_dq_kernel"
             "((anonymous namespace)::FlashArgs)", "flash_attention_bwd"),
            ("(anonymous namespace)::k2_bwd_dkv_kernel"
             "((anonymous namespace)::FlashArgs)", "flash_attention_bwd")):
        assert _group(name) == group, name
