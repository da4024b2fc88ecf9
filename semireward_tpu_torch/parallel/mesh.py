"""Device mesh over ``torch.distributed`` ranks (port of
``semireward_tpu/parallel/mesh.py``).

The JAX package builds one ``jax.sharding.Mesh`` over its devices and lets
GSPMD partition one global program: every batch mean, count and scatter of
the step is global. Here each rank is one process on one device, and the
same step runs on every rank on its own rows; what GSPMD inserted
implicitly is written out:

- ``build_mesh`` resolves ``-1`` and checks the shape against the ranks as
  JAX's does (a YAML mesh the ranks do not fit fails with JAX's message),
  and makes one process group a set of axes: the batch axes (``data`` and
  ``fsdp``), ``fsdp`` and ``model``.
- Rows: the batch shards over the batch axes. Rank ``r`` of that group
  holds global rows ``[r * n, (r + 1) * n)`` (JAX's
  ``make_array_from_process_local_data`` order); ranks that differ only
  on ``model`` hold the same rows (Megatron). ``local_rows`` cuts a
  global batch so.
- Parameters (:class:`Layout`): the JAX package's rules, leaf for leaf:
  ``fsdp_leaf_dim`` (leaves of at least ``min_size`` elements shard their
  largest divisible dim over ``fsdp``) and ``tp_leaf_dims`` (Megatron:
  column kernels shard their output dim over ``model``, row kernels their
  input dim, column biases with their output; ``extra_axis`` lays ``fsdp``
  on the other dim), matched on the port's module names and applied to the
  flax dim each torch dim holds (``convert.py``: a Linear's ``weight`` is
  the flax kernel transposed). The EMA shadow and the optimizer moments
  take their parameter's layout; BatchNorm statistics, the algorithm and
  SemiReward state are replicated. FSDP leaves live as their shard between
  steps and are gathered around the forward and backward; the gradient is
  reduce-scattered (NCCL) or all-reduced and cut (gloo); the optimizer and
  the EMA run on the shards. TP leaves stay local.
- The step's loss on each rank is its local mean divided by the number of
  batch shards, so that the sum of every rank's gradient is the gradient of
  the global mean, and every gradient reduction is a sum.

A mesh is *active* (:func:`active`) once the process has joined a group
(``setup_distributed``: torchrun's ``WORLD_SIZE`` > 1 or
``extra['multihost']``); without one every function here is the identity
and the port runs as on one device. The legacy ``world_size`` / ``rank`` /
``dist_url`` config keys stay unused, as in the JAX package.
"""
from __future__ import annotations

import datetime
import itertools
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

BATCH_AXES = ("data", "fsdp")
# Megatron's column- and row-parallel kernels, matched on the module's own
# name exactly (BERT's classifier_fc1 and HuBERT's fp_proj replicate); the
# fused ViT qkv is not column-sharded (its q/k/v thirds would straddle the
# shards): TP configs set net_kwargs['split_qkv']
COL_KERNELS = frozenset(("fc1", "q", "k", "v", "query", "key", "value",
                         "intermediate", "ff1"))
ROW_KERNELS = frozenset(("proj", "fc2", "out", "output", "ff2"))

_ACTIVE: Optional["Mesh"] = None


def resolve_shape(mesh_shape: Sequence[int], n: int) -> Tuple[int, ...]:
    """JAX's ``build_mesh`` resolution: one ``-1`` takes ``n`` over the
    product of the others; the product must then be ``n``."""
    shape = [int(s) for s in mesh_shape]
    if shape.count(-1) == 1:
        known = int(np.prod([s for s in shape if s != -1])) or 1
        shape[shape.index(-1)] = n // known
    if int(np.prod(shape)) != n:
        raise AssertionError(f"mesh shape {shape} != {n} devices")
    return tuple(shape)


class Mesh:
    """Axis names, sizes and this rank's coordinates (row-major, rank 0 at
    the origin, as the JAX package's enumeration order), with one process
    group for each set of axes the step reduces over when the process has
    joined a group (``groups`` True)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int = 0, groups: bool = True):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.world = int(np.prod(list(self.shape.values())))
        self.rank = rank
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(
                                   rank, tuple(self.shape.values())))))
        self.batch_axes = batch_shard_axes(self)
        self._groups: Dict[Tuple[str, ...], object] = {}
        self.backend = None
        if groups and dist.is_available() and dist.is_initialized():
            self.backend = dist.get_backend()
            wanted = {self.batch_axes, ("fsdp",), ("model",), ("data",)}
            for axes in sorted(wanted):
                if all(a in self.shape for a in axes):
                    self._groups[axes] = self._new_groups(axes)

    def _new_groups(self, axes: Tuple[str, ...]):
        """Every rank calls ``new_group`` for every group of ``axes`` (the
        ranks that share the other axes' coordinates), in one order, and
        keeps its own. A group's ranks ascend with their index over
        ``axes``, so a group rank is that index."""
        others = [a for a in self.axis_names if a not in axes]
        shape = tuple(self.shape.values())
        mine = None
        for fixed in itertools.product(*(range(self.shape[a])
                                          for a in others)):
            ranks = sorted(
                int(np.ravel_multi_index(tuple(
                    dict(zip(others, fixed), **dict(zip(axes, c)))[a]
                    for a in self.axis_names), shape))
                for c in itertools.product(*(range(self.shape[a])
                                             for a in axes)))
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = g
        return mine

    def size(self, axes: Iterable[str]) -> int:
        return int(np.prod([self.shape[a] for a in axes if a in self.shape]))

    def index(self, axes: Iterable[str]) -> int:
        """This rank's row-major index over ``axes``."""
        idx = 0
        for a in axes:
            if a in self.shape:
                idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes: Iterable[str]):
        """The process group over ``axes`` (a group of one rank where their
        size is 1), or None without a process group."""
        axes = tuple(a for a in axes if a in self.shape)
        return self._groups.get(axes) if axes else None

    @property
    def batch_shards(self) -> int:
        return self.size(self.batch_axes)

    @property
    def batch_index(self) -> int:
        return self.index(self.batch_axes)

    @property
    def tp(self) -> int:
        return self.shape.get("model", 1)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"batch_axes={self.batch_axes})")


def batch_shard_axes(mesh) -> Tuple[str, ...]:
    """The axes a batch dim shards over: ``data``, and ``fsdp`` on the 2-D
    layout (FSDP computes batch-parallel over both)."""
    names = mesh.axis_names
    return tuple(a for a in BATCH_AXES if a in names)


def build_mesh(mesh_shape: Sequence[int] = (-1,),
               axis_names: Sequence[str] = ("data",),
               world: Optional[int] = None, rank: Optional[int] = None
               ) -> Mesh:
    """The mesh of ``world`` ranks (default: the process group's, else 1)
    with JAX's ``-1`` resolution and its assertion."""
    joined = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if joined else 1
    if rank is None:
        rank = dist.get_rank() if joined else 0
    return Mesh(resolve_shape(mesh_shape, world), axis_names, rank)


def setup_distributed(cfg=None, device=None,
                      timeout_s: float = 1800.0) -> Tuple[int, int]:
    """Join the process group when torchrun's ``WORLD_SIZE`` > 1 or
    ``extra['multihost']`` is set (NCCL for a CUDA device, gloo for the
    CPU; the address, rank and size from torchrun's environment). A
    coordinator that fails raises; a group already joined is kept.
    Returns ``(rank, world)``."""
    extra = getattr(cfg, "extra", {}) or {}
    want = (int(os.environ.get("WORLD_SIZE", "1")) > 1
            or bool(extra.get("multihost", False)))
    if want and not dist.is_initialized():
        dev = torch.device(device) if device is not None else None
        backend = ("nccl" if dev is None and torch.cuda.is_available()
                   or dev is not None and dev.type == "cuda" else "gloo")
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=timeout_s))
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def activate(mesh: Optional[Mesh]) -> None:
    """Make ``mesh`` the one the algorithms' global reductions, the
    BatchNorm moments and the row draws read (None: none)."""
    global _ACTIVE
    _ACTIVE = mesh
    from semireward_tpu_torch import rng
    if mesh is None:
        rng.set_shards()
    else:
        rng.set_shards(rows=(mesh.batch_index, mesh.batch_shards),
                       cols=(mesh.index(("model",)), mesh.tp))


def active() -> Optional[Mesh]:
    return _ACTIVE


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------

def local_rows(batch, mesh: Mesh):
    """This rank's rows of a global batch (a tensor, an array or a dict of
    them, nested dicts for token views): block ``batch_index`` of
    ``batch_shards`` along dim 0, as ``put_global_batch`` lays them out."""
    if isinstance(batch, dict):
        return {k: local_rows(v, mesh) for k, v in batch.items()}
    n = batch.shape[0] // mesh.batch_shards
    if n * mesh.batch_shards != batch.shape[0]:
        raise ValueError(f"{batch.shape[0]} rows do not shard over "
                         f"{mesh.batch_shards} batch ranks")
    i = mesh.batch_index
    return batch[i * n:(i + 1) * n]


def _all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    n = dist.get_world_size(group)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


@torch.no_grad()
def concat_all_gather(t: torch.Tensor, mesh: Optional[Mesh] = None
                      ) -> torch.Tensor:
    """The global rows of ``t`` (every batch rank's rows in rank order), no
    gradient; ``t`` itself without an active mesh."""
    mesh = mesh or _ACTIVE
    g = mesh.group(mesh.batch_axes) if mesh is not None else None
    return t if g is None else _all_gather(t.detach(), g)


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------

def _reduce(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, group=group)
    return t


class _SumGrad(torch.autograd.Function):
    """Identity forward; the gradient summed over ``group``: a tensor
    replicated over the group whose uses differ by rank (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _SumFwd(torch.autograd.Function):
    """The sum over ``group`` forward, identity backward (Megatron's g:
    the row-parallel partials)."""

    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBoth(torch.autograd.Function):
    """A global sum every rank's loss reads (BatchNorm's moments): summed
    forward, and its gradient summed backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _Split(torch.autograd.Function):
    """This rank's block of the last dim forward; the blocks gathered
    backward (the input of a row-parallel kernel that no column-parallel
    one produced)."""

    @staticmethod
    def forward(ctx, x, group, index, n):
        ctx.group = group
        w = x.shape[-1] // n
        return x[..., index * w:(index + 1) * w].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, dim=-1), None, None, None


def sum_grad(x, group):
    return x if group is None else _SumGrad.apply(x, group)


def sum_fwd(x, group):
    return x if group is None else _SumFwd.apply(x, group)


def global_sum(x, mesh: Optional[Mesh] = None):
    """``x`` summed over the batch ranks, with its gradient (the identity
    without an active mesh)."""
    mesh = mesh or _ACTIVE
    g = mesh.group(mesh.batch_axes) if mesh is not None else None
    return x if g is None else _SumBoth.apply(x, g)


@torch.no_grad()
def global_mean_(values: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Scalars averaged over the batch ranks, in one reduction."""
    g = mesh.group(mesh.batch_axes)
    if g is None or not values:
        return values
    flat = torch.stack([v.float().reshape(()) for v in values])
    dist.all_reduce(flat, group=g)
    flat /= mesh.batch_shards
    return [f.to(v.dtype) for f, v in zip(flat.unbind(0), values)]


# ---------------------------------------------------------------------------
# tensor parallelism inside the models
# ---------------------------------------------------------------------------

def tp_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` where its ``model`` axis splits anything, else None."""
    return mesh if mesh is not None and mesh.tp > 1 else None


def col_linear(x, layer: nn.Linear, dtype, mesh: Mesh):
    """Column-parallel: ``x`` is the same on every model rank, ``layer``
    holds this rank's output rows; the input's gradient is summed over
    ``model``."""
    xin = sum_grad(x, mesh.group(("model",)))
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return torch.nn.functional.linear(xin.to(dtype), layer.weight.to(dtype),
                                      bias)


def row_linear(x, layer: nn.Linear, dtype, mesh: Mesh, local_in: bool = True):
    """Row-parallel: ``layer`` holds this rank's input columns; the partial
    products are summed over ``model`` and the (replicated) bias added
    after. ``local_in`` False: ``x`` is whole on every model rank and this
    rank takes its block of it."""
    group = mesh.group(("model",))
    if not local_in:
        x = _Split.apply(x, group, mesh.index(("model",)), mesh.tp)
    y = torch.nn.functional.linear(x.to(dtype), layer.weight.to(dtype))
    y = sum_fwd(y, group)
    return y if layer.bias is None else y + layer.bias.to(dtype)


def is_split(layer: nn.Linear, full: int, dim: int) -> bool:
    """Whether ``layer``'s weight holds a block of ``full`` along ``dim``
    (0: a column kernel's outputs, 1: a row kernel's inputs)."""
    return layer.weight.shape[dim] < full


# ---------------------------------------------------------------------------
# the JAX package's layout rules, on the flax dims of the port's leaves
# ---------------------------------------------------------------------------

def _flax_perm(module: nn.Module, pname: str, ndim: int):
    """torch dim i of a leaf holds flax dim ``perm[i]`` (``convert.py``):
    Linear and Conv weights are flax kernels transposed; every other leaf
    keeps its dims."""
    if pname == "weight" and isinstance(module, nn.Linear):
        return (1, 0)
    if pname == "weight" and isinstance(module, nn.Conv2d):
        return (3, 2, 0, 1)
    if pname == "weight" and isinstance(module, nn.Conv1d):
        return (2, 1, 0)
    return tuple(range(ndim))


def fsdp_leaf_dim(flax_shape: Sequence[int], n_shard: int,
                  min_size: int = 2 ** 16) -> Optional[int]:
    """``_fsdp_leaf_spec``: the flax dim a leaf shards over ``fsdp``, or
    None (replicated): leaves under ``min_size`` elements replicate, else
    the largest dim that ``n_shard`` divides (ties: the first)."""
    dims = list(flax_shape)
    if int(np.prod(dims)) < min_size:
        return None
    order = sorted(range(len(dims)), key=lambda i: -dims[i])
    return next((i for i in order if dims[i] % n_shard == 0
                 and dims[i] >= n_shard), None)


def tp_leaf_dims(parent: str, leaf: str, flax_shape: Sequence[int],
                 n_model: int, n_extra: Optional[int] = None
                 ) -> Dict[str, int]:
    """``tp_param_sharding``'s rule for one leaf: ``{axis: flax dim}``
    (``model`` and, with ``n_extra``, ``fsdp`` on the other kernel dim)."""
    nd = len(flax_shape)
    div = lambda d, n: n is not None and nd >= 1 and flax_shape[d] % n == 0
    if parent in COL_KERNELS:
        if leaf == "kernel" and nd == 2 and div(1, n_model):
            return {"model": 1, **({"fsdp": 0} if div(0, n_extra) else {})}
        if leaf == "bias" and nd == 1 and div(0, n_model):
            return {"model": 0}
    if parent in ROW_KERNELS:
        if leaf == "kernel" and nd == 2 and div(0, n_model):
            return {"model": 0, **({"fsdp": 1} if div(1, n_extra) else {})}
    return {}


def layout_kind(mesh) -> str:
    """As the JAX trainer picks: ``tp`` where the mesh has a ``model`` axis,
    ``fsdp`` where it has ``fsdp``, else ``data`` (everything replicated)."""
    if "model" in mesh.axis_names:
        return "tp"
    return "fsdp" if "fsdp" in mesh.axis_names else "data"


def param_specs(mesh, model: nn.Module, min_size: int = 2 ** 16
                ) -> Dict[str, Dict[str, int]]:
    """``{parameter name: {axis: torch dim}}`` of ``model`` under the
    JAX package's rule for ``mesh``'s kind (an empty dict: replicated)."""
    kind = layout_kind(mesh)
    out = {}
    for mod_name, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{pname}" if mod_name else pname
            perm = _flax_perm(mod, pname, p.ndim)
            flax_shape = [0] * p.ndim
            for t, f in enumerate(perm):
                flax_shape[f] = p.shape[t]
            leaf = "kernel" if perm != tuple(range(p.ndim)) else pname
            if kind == "fsdp":
                f = fsdp_leaf_dim(flax_shape, mesh.shape["fsdp"], min_size)
                dims = {} if f is None else {"fsdp": f}
            elif kind == "tp":
                extra = mesh.shape.get("fsdp")
                dims = tp_leaf_dims(mod_name.rsplit(".", 1)[-1], leaf,
                                    flax_shape, mesh.shape["model"], extra)
            else:
                dims = {}
            out[name] = {a: perm.index(f) for a, f in dims.items()}
    return out


def flax_spec(specs: Dict[str, int], model: nn.Module, name: str
              ) -> Tuple[Optional[str], ...]:
    """A leaf's layout as JAX's ``PartitionSpec`` over its flax dims."""
    mod_name, _, pname = name.rpartition(".")
    p = model.get_parameter(name)
    perm = _flax_perm(model.get_submodule(mod_name), pname, p.ndim)
    spec = [None] * p.ndim
    for axis, t in specs.items():
        spec[perm[t]] = axis
    return tuple(spec)


# ---------------------------------------------------------------------------
# the layout of a model's parameters and their state
# ---------------------------------------------------------------------------

def _block(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    w = t.shape[dim] // n
    return t.narrow(dim, i * w, w)


class Layout:
    """Where each parameter of ``model`` lives on ``mesh`` (``param_specs``)
    and what the step does about it. ``shard_`` cuts every parameter to
    this rank's block once, before the EMA shadow and the optimizer moments
    are made from them. Around each forward and backward ``gather_`` puts
    the whole FSDP leaves in place and ``release_`` the shards back;
    ``sync`` turns the step's gradients into this rank's reduced blocks;
    ``sq_norm`` is the global-norm clip's sum of squares over all
    blocks; ``full`` / ``local`` convert a leaf of the state between its
    whole value and this rank's block (checkpoints)."""

    def __init__(self, mesh: Mesh, model: nn.Module,
                 min_size: int = 2 ** 16):
        self.mesh = mesh
        self.kind = layout_kind(mesh)
        self.specs = param_specs(mesh, model, min_size)
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self._rest: Dict[int, torch.Tensor] = {}

    def _axes(self, name):
        return self.specs.get(name, {})

    @torch.no_grad()
    def shard_(self) -> None:
        for name, p in zip(self.names, self.params):
            t = p.data
            for axis, dim in self._axes(name).items():
                t = _block(t, dim, self.mesh.shape[axis],
                           self.mesh.coords[axis])
            p.data = t.contiguous().clone()

    def local(self, name: str, full: torch.Tensor,
              axes: Sequence[str] = ("fsdp", "model")) -> torch.Tensor:
        """This rank's block (over ``axes``) of a whole leaf of ``name``."""
        t = full
        for axis, dim in self._axes(name).items():
            if axis in axes:
                t = _block(t, dim, self.mesh.shape[axis],
                           self.mesh.coords[axis])
        return t.contiguous()

    @torch.no_grad()
    def full(self, name: str, t: torch.Tensor,
             axes: Sequence[str] = ("fsdp", "model")) -> torch.Tensor:
        """A leaf of ``name`` gathered whole over ``axes`` (a collective)."""
        for axis, dim in self._axes(name).items():
            if axis in axes:
                t = _all_gather(t, self.mesh.group((axis,)), dim)
        return t

    @torch.no_grad()
    def gather_(self) -> None:
        for name, p in zip(self.names, self.params):
            dim = self._axes(name).get("fsdp")
            if dim is not None and self.mesh.shape["fsdp"] > 1:
                self._rest[id(p)] = p.data
                p.data = _all_gather(p.data, self.mesh.group(("fsdp",)), dim)

    @torch.no_grad()
    def release_(self) -> None:
        for p in self.params:
            rest = self._rest.pop(id(p), None)
            if rest is not None:
                p.data = rest

    @torch.no_grad()
    def sync(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each gradient summed over the batch ranks and cut to this rank's
        FSDP block."""
        mesh, out = self.mesh, list(grads)
        bg = mesh.group(mesh.batch_axes)
        flat = [i for i in range(len(self.params))
                if "fsdp" not in self._axes(self.names[i])]
        if bg is not None and flat:
            buf = torch.cat([out[i].reshape(-1) for i in flat])
            dist.all_reduce(buf, group=bg)
            for i, part in zip(flat, buf.split([out[i].numel()
                                                for i in flat])):
                out[i] = part.view_as(out[i])
        n_f = mesh.shape.get("fsdp", 1)
        for i in range(len(self.params)):
            dim = self._axes(self.names[i]).get("fsdp")
            if dim is None:
                continue
            g, f = out[i], mesh.coords["fsdp"]
            if bg is None:
                out[i] = _block(g, dim, n_f, f).contiguous()
            elif mesh.backend == "nccl" and n_f > 1:
                chunks = g.movedim(dim, 0).contiguous()
                part = torch.empty_like(_block(chunks, 0, n_f, 0))
                dist.reduce_scatter_tensor(part, chunks,
                                           group=mesh.group(("fsdp",)))
                dg = mesh.group(("data",))
                if dg is not None:
                    dist.all_reduce(part, group=dg)
                out[i] = part.movedim(0, dim).contiguous()
            else:
                g = _reduce(g, bg)
                out[i] = _block(g, dim, n_f, f).contiguous()
        return out

    @torch.no_grad()
    def sq_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The squared global norm of the gradient over every block: each
        leaf's local sum of squares, summed over the axes it is split on."""
        sq = torch.stack(torch._foreach_norm(list(grads))) ** 2
        kinds: Dict[Tuple[str, ...], List[int]] = {}
        for i, name in enumerate(self.names):
            axes = tuple(a for a in ("fsdp", "model")
                         if a in self._axes(name))
            kinds.setdefault(axes, []).append(i)
        total = sq.new_zeros(())
        for axes, idx in kinds.items():
            s = sq[idx].sum()
            for a in axes:
                g = self.mesh.group((a,))
                if g is not None:
                    s = _reduce(s, g)
            total = total + s
        return total


STATE_PREFIXES = ("model.", "ema.", "opt.mu.", "opt.nu.", "opt.trace.")


def param_of(key: str) -> Optional[str]:
    """The parameter a state leaf belongs to (``ema.blocks.0.mlp.fc1.weight``
    -> ``blocks.0.mlp.fc1.weight``), or None."""
    for pre in STATE_PREFIXES:
        if key.startswith(pre):
            return key[len(pre):]
    return None
