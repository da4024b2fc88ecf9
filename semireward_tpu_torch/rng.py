"""Random draws from an explicit generator, made on the generator's device.

Every random draw of the port takes a ``torch.Generator``. These functions
draw on the generator's own device and move the result to the device the
caller asks for. A generator on the training device draws there, as torch
does. A CPU generator seeded as a CPU run's gives that run's numbers to a
run on the card, so one seed names one run on every device (as a JAX key
names one stream on every backend): ``Trainer(..., rng_device='cpu')``.
"""
from __future__ import annotations

from typing import Optional

import torch


def _same(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def _move(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``. A host draw goes to the card through pinned
    memory without a stream sync, so the host runs on ahead of the card as
    it does when the card draws."""
    device = torch.device(device)
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _draw(fn, *args, generator=None, device=None, **kw):
    if generator is None:
        return fn(*args, device=device, **kw)
    out = fn(*args, generator=generator, device=generator.device, **kw)
    return out if device is None else _move(out, device)


# (index, count) of this rank's block of the batch rows and of the model
# axis's columns: a draw made for the rows (or a tensor-parallel block) of
# a global batch is drawn at the global size and cut, so W ranks draw what
# one process draws for the whole batch (parallel/mesh.py:activate)
_SHARDS = {"rows": (0, 1), "cols": (0, 1)}


def set_shards(rows=(0, 1), cols=(0, 1)) -> None:
    _SHARDS["rows"], _SHARDS["cols"] = tuple(rows), tuple(cols)


def _global_size(size, rows: Optional[int], cols: Optional[int]):
    """The global draw's size and the (dim, start, length) cuts back to
    this rank's block."""
    if len(size) == 1 and isinstance(size[0], (tuple, list, torch.Size)):
        size = tuple(size[0])
    size, cuts = list(size), []
    for dim, key in ((rows, "rows"), (cols, "cols")):
        i, n = _SHARDS[key]
        if dim is not None and n > 1:
            cuts.append((dim, i * size[dim], size[dim]))
            size[dim] *= n
    return tuple(size), cuts


def _cut(out: torch.Tensor, cuts) -> torch.Tensor:
    for dim, start, length in cuts:
        out = out.narrow(dim, start, length)
    return out.contiguous() if cuts else out


def rand(*size, generator: Optional[torch.Generator] = None, device=None,
         rows: Optional[int] = None, cols: Optional[int] = None,
         **kw) -> torch.Tensor:
    """``torch.rand``; ``rows`` / ``cols`` name the dims that hold this
    rank's block of the batch rows / of the model axis (see
    ``set_shards``)."""
    size, cuts = _global_size(size, rows, cols)
    return _cut(_draw(torch.rand, size, generator=generator, device=device,
                      **kw), cuts)


def randn(*size, generator: Optional[torch.Generator] = None, device=None,
          rows: Optional[int] = None, **kw) -> torch.Tensor:
    size, cuts = _global_size(size, rows, None)
    return _cut(_draw(torch.randn, size, generator=generator, device=device,
                      **kw), cuts)


def randint(low: int, high: int, size,
            generator: Optional[torch.Generator] = None, device=None,
            rows: Optional[int] = None, **kw) -> torch.Tensor:
    size, cuts = _global_size((size,), rows, None)
    return _cut(_draw(torch.randint, low, high, size, generator=generator,
                      device=device, **kw), cuts)


def randperm(n: int, generator: Optional[torch.Generator] = None,
             device=None, **kw) -> torch.Tensor:
    return _draw(torch.randperm, n, generator=generator, device=device, **kw)


def dirichlet(conc: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A draw from ``Dirichlet(conc)``, on ``conc``'s device."""
    if generator is None or _same(generator.device, conc.device):
        return torch._sample_dirichlet(conc, generator=generator)
    return _move(torch._sample_dirichlet(conc.to(generator.device),
                                         generator=generator), conc.device)


@torch.no_grad()
def init_(t: torch.Tensor, fn, *args,
          generator: Optional[torch.Generator] = None, **kw) -> torch.Tensor:
    """``fn(t, *args, generator=generator, **kw)``, an in-place draw such
    as ``torch.Tensor.normal_`` or ``nn.init.trunc_normal_``; made on the
    generator's device and copied into ``t`` where that is another."""
    if generator is None or _same(generator.device, t.device):
        fn(t, *args, generator=generator, **kw)
        return t
    buf = torch.empty(t.shape, dtype=t.dtype, device=generator.device)
    fn(buf, *args, generator=generator, **kw)
    return t.copy_(buf)
