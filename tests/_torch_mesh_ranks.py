"""What each gloo rank of the mesh tests runs (imports no JAX; see
``_torch_dist.run_ranks``). The same functions run in the test process
with ``mesh=None`` for the port's own one-process reference."""
import numpy as np
import torch

from semireward_tpu_torch.config import get_config
from semireward_tpu_torch.core import checkpoint as ckpt
from semireward_tpu_torch.core.step import init_train_state, make_train_step
from semireward_tpu_torch.models import vit as tvit
from semireward_tpu_torch.models import wrn as twrn
from semireward_tpu_torch.ops import attention as TA
from semireward_tpu_torch.ops import fused_mlp as TF
from semireward_tpu_torch.parallel import mesh as mesh_lib
from semireward_tpu_torch.registry import ALGORITHMS

CPU = torch.device("cpu")
BUILDERS = {"vit": tvit.vit_small_patch2_32, "wrn": twrn.wrn_28_2}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(t):
    return t.detach().cpu().numpy().copy()


def _batch(b):
    return {k: _t(v) for k, v in b.items()}


def _mesh(case):
    if case.get("mesh_shape") is None:
        return None
    return mesh_lib.build_mesh(case["mesh_shape"], case["mesh_axes"])


def run_case(case, mesh=None):
    """``case['steps']`` train steps of ``case['algorithm']`` on the global
    batches ``case['batches']`` (this rank's rows of each on a mesh) from
    the whole weights ``case['weights']``; after each step the metrics and
    the whole state (``checkpoint.full_leaves``), and the bytes this rank
    holds of each parameter, EMA and moment leaf."""
    mesh_lib.activate(mesh)
    try:
        cfg = get_config(**case["cfg"])
        cfg.extra.update(case.get("extra", {}))
        alg = ALGORITHMS.get(case["algorithm"])(cfg, case["data_info"], CPU)
        builder = BUILDERS[case["net"]]
        model = builder(num_classes=cfg.num_classes, dtype=torch.float32,
                        fused_mesh=mesh, **case["arch"])
        model.load_state_dict({k: _t(v) for k, v in case["weights"].items()},
                              strict=False)
        state = init_train_state(cfg, alg, model, builder=builder, mesh=mesh,
                                 fsdp_min_size=case.get("fsdp_min_size",
                                                        2 ** 16))
        if state.sr is not None and "rewarder" in case:
            state.sr.rewarder.load_state_dict(
                {k: _t(v) for k, v in case["rewarder"].items()})
            state.sr.generator.load_state_dict(
                {k: _t(v) for k, v in case["generator"].items()})
        step = make_train_step(cfg, alg)
        names = [n for n, _ in model.named_parameters()]
        opt = state.opt.state_dict()
        moments = {k: [opt[f"{k}.{n}"] for n in names]
                   for k in ("mu", "nu", "trace") if f"{k}.{names[0]}" in opt}
        out = {"bytes": {"model": _bytes(names, model.parameters()),
                         "ema": _bytes(names, state.ema),
                         **{k: _bytes(names, v) for k, v in moments.items()}},
               "full_bytes": {n: int(np.asarray(v).nbytes)
                              for n, v in case["weights"].items()},
               "steps": []}
        for b in case["batches"][:case.get("steps", 3)]:
            b = _batch(b)
            if mesh is not None:
                b = mesh_lib.local_rows(b, mesh)
            m = step(state, b)
            full = ckpt.full_leaves(state)
            out["steps"].append({
                "metrics": {k: float(v) for k, v in m.items() if v.ndim == 0},
                "state": {k: _np(v) for k, v in full.items() if k != "rng"}})
        if case.get("save_to") and mesh is not None:
            # every rank gathers, rank 0 writes; then a fresh layout reads
            # the file back and cuts it to its blocks
            path = case["save_to"]
            ckpt.save_checkpoint(path, state, {"it": state.step},
                                 write=mesh.rank == 0)
            torch.distributed.barrier()
            live = {k: v.clone() for k, v in state.state_dict().items()
                    if k != "rng"}
            ckpt.load_checkpoint(path, state)
            out["resumed_equal"] = all(
                torch.equal(live[k], v) for k, v in
                state.state_dict().items() if k != "rng")
        return out
    finally:
        mesh_lib.activate(None)


def _bytes(names, tensors):
    return {n: t.numel() * t.element_size() for n, t in zip(names, tensors)}


def step_cases(rank, world, cases):
    """Each case on its own mesh of the ``world`` gloo ranks; then, on rank
    0, each on the whole batch in this process alone (no mesh)."""
    out = {"mesh": [run_case(c, _mesh(c)) for c in cases]}
    if rank == 0:
        out["one"] = [run_case(dict(c, save_to=None)) for c in cases]
    return out


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

def _grads(out, inputs, g):
    return [_np(t) for t in torch.autograd.grad(out, inputs, g)]


def k4_forms(rank, world, mlp, attn):
    """K4's forms on this rank's block of the whole inputs: the data-
    parallel MLP on 4 batch ranks, the Megatron MLP on 2 x 2 data x model,
    the attention on 4 batch ranks and on 2 x 2 (batch x heads), each
    output and gradient returned as this rank's block; the attention's
    keep mask as its kernel counter draws it."""
    out = {}
    for name, shape, axes in (("dp", (4,), ("data",)),
                              ("tp", (2, 2), ("data", "model"))):
        mesh = mesh_lib.build_mesh(shape, axes)
        x = mesh_lib.local_rows(_t(mlp["x"]), mesh).requires_grad_()
        w1, b1, w2, b2 = (_t(mlp[k]) for k in ("w1", "b1", "w2", "b2"))
        if name == "tp":
            i, n = mesh.index(("model",)), mesh.tp
            h = w1.shape[0] // n
            w1, b1, w2 = w1[i * h:(i + 1) * h], b1[i * h:(i + 1) * h], \
                w2[:, i * h:(i + 1) * h]
        ws = [t.clone().requires_grad_() for t in (w1, b1, w2, b2)]
        y = (TF.fused_mlp_sharded(x, *ws, mesh=mesh) if name == "dp" else
             TF.fused_mlp_tp_sharded(x, *ws, mesh=mesh,
                                     hidden=mlp["w1"].shape[0]))
        g = mesh_lib.local_rows(_t(mlp["g"]), mesh)
        grads = torch.autograd.grad(y, [x] + ws, g)
        # the step's sum of the weights' gradients over the batch ranks
        synced = [t.clone() for t in grads[1:]]
        for t in synced:
            torch.distributed.all_reduce(t, group=mesh.group(mesh.batch_axes))
        out[f"mlp_{name}"] = {"y": _np(y), "grads": [_np(t) for t in grads],
                              "synced": [_np(t) for t in synced]}
    for name, shape, axes in (("batch", (4,), ("data",)),
                              ("batch_heads", (2, 2), ("data", "model"))):
        mesh = mesh_lib.build_mesh(shape, axes)
        q, k, v, g = (mesh_lib.local_rows(_t(attn[n]), mesh)
                      for n in ("q", "k", "v", "g"))
        bias = mesh_lib.local_rows(_t(attn["bias"]), mesh)
        if mesh.tp > 1:
            i, n = mesh.index(("model",)), mesh.tp
            hl = q.shape[2] // n
            q, k, v, g = (t[:, :, i * hl:(i + 1) * hl] for t in (q, k, v, g))
        q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
        seed = torch.tensor([attn["seed"]], dtype=torch.int32)
        o = TA.flash_fn(mesh)(q, k, v, bias=bias,
                              dropout_rate=attn["rate"], dropout_seed=seed)
        B, N, Hl, _ = q.shape
        H = Hl * mesh.tp
        keep = TA.attention_keep_mask(
            seed, B * Hl, N, TA.padded_len(N), TA.keep_threshold(attn["rate"]),
            bh_offset=mesh.batch_index * B * H + mesh.index(("model",)) * Hl,
            local_heads=Hl, head_stride=H)
        out[f"attn_{name}"] = {"o": _np(o), "grads": _grads(o, [q, k, v], g),
                               "keep": _np(keep)}
    return out


# ---------------------------------------------------------------------------
# the trainer on a mesh
# ---------------------------------------------------------------------------

def trainer_run(rank, world, cfg_dict):
    """A CPU ``Trainer`` on the ranks' group (as under torchrun): its
    results, log history, checkpoint writes and the files under its
    save dir."""
    import os
    from semireward_tpu_torch.core.trainer import Trainer
    cfg = get_config(**cfg_dict)
    tr = Trainer(cfg, device="cpu")
    results = tr.train()
    save = os.path.join(cfg.save_dir, cfg.save_name)
    return {"results": results, "log": tr.log_history,
            "writes": len(tr.ckpt_writes), "mesh": repr(tr.mesh),
            "batch": cfg.batch_size // tr.mesh.batch_shards,
            "files": sorted(os.listdir(save)) if os.path.isdir(save) else []}
