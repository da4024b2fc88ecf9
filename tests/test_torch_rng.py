"""``semireward_tpu_torch/rng.py``: every draw of the port is made on its
generator's device and moved to the caller's.

- With the generator on the caller's device a draw is torch's own draw,
  bit for bit, and leaves the generator where torch's leaves it.
- For another device (``meta`` here, the card in
  ``test_torch_kernels_cuda.py``) the draw comes from the generator's own
  stream: the generator advances as a twin that drew on its device, and
  the result lands on the asked device with torch's shape and dtype.
"""
import pytest
import torch
from torch import nn

from semireward_tpu_torch import rng

DRAWS = [
    ("rand", (3, 5), {}),
    ("randn", (4, 2), {}),
    ("randint", (0, 9, (7,)), {"dtype": torch.int32}),
    ("randperm", (11,), {}),
]


def _twins(seed=3):
    return (torch.Generator().manual_seed(seed) for _ in range(2))


@pytest.mark.parametrize("name,args,kw", DRAWS)
def test_a_draw_on_the_generators_device_is_torchs(name, args, kw):
    g, twin = _twins()
    got = getattr(rng, name)(*args, generator=g, device="cpu", **kw)
    want = getattr(torch, name)(*args, generator=twin, device="cpu", **kw)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(g.get_state(), twin.get_state())


@pytest.mark.parametrize("name,args,kw", DRAWS)
def test_a_draw_for_another_device_comes_from_the_generators_stream(
        name, args, kw):
    g, twin = _twins()
    got = getattr(rng, name)(*args, generator=g, device="meta", **kw)
    want = getattr(torch, name)(*args, generator=twin, **kw)
    assert got.device.type == "meta"
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert torch.equal(g.get_state(), twin.get_state())


def test_a_draw_without_a_generator_takes_the_asked_device():
    assert rng.rand(2, device="meta").device.type == "meta"
    assert rng.randint(0, 3, (2,)).device.type == "cpu"


@pytest.mark.parametrize("fn,args", [
    (torch.Tensor.uniform_, (-0.5, 0.5)),
    (torch.Tensor.normal_, (0.0, 0.02)),
    (nn.init.trunc_normal_, (0.0, 1.0, -2.0, 2.0)),
])
def test_an_inplace_init_draws_on_the_generators_device(fn, args):
    g, twin = _twins()
    t, want = torch.empty(6, 4), torch.empty(6, 4)
    assert rng.init_(t, fn, *args, generator=g) is t
    fn(want, *args, generator=twin)
    assert torch.equal(t, want)
    g, twin = _twins()
    m = torch.empty(6, 4, device="meta")
    assert rng.init_(m, fn, *args, generator=g) is m
    fn(torch.empty(6, 4), *args, generator=twin)
    assert torch.equal(g.get_state(), twin.get_state())


def test_dirichlet_draws_on_the_generators_device():
    conc = torch.full((2,), 0.75)
    g, twin = _twins()
    got = rng.dirichlet(conc, g)
    assert torch.equal(got, torch._sample_dirichlet(conc, generator=twin))
    assert torch.allclose(got.sum(), torch.tensor(1.0))
