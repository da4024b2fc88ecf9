"""A golden run on the card from the CPU generator's draws, against the same
run on the CPU: does the card's result follow its random stream or its
code?

    python -m semireward_tpu_torch.draw_witness [--algorithm flexmatch]
        [--seeds 0 1 6] [--iters 1000] [--out FILE]

For each seed, three runs of ``validation.golden_config(algorithm,
iters=, seed=)`` with the unlabeled loss on:

- ``cpu``: the whole run on the CPU;
- ``card_cpu_draws``: on the card from a CPU generator seeded as the CPU
  run's (``Trainer(..., rng_device='cpu')``, as ``run_golden``), so that
  it sees the CPU run's initial state and draws;
- ``card``: on the card with its own CUDA generator.

In the two card runs every FlexMatch curriculum update
(``algorithms/common.py:flex_mask``) is recomputed on the CPU from the
card's own inputs (its probabilities, indices and previous state) and
compared bit for bit: ``selected_label``, ``classwise_acc`` and the mask.
The CPU run and ``card_cpu_draws`` are compared step by step: the first
step whose ``selected_label`` differs, and the first whose losses differ
by more than 1e-3. One JSON line a seed, then the card's ``nvidia-smi``
line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch


@contextlib.contextmanager
def checked_flex_updates(log):
    """Record every ``flex_mask`` call's new ``selected_label`` in
    ``log``; off the CPU, recompute the update on the CPU from the same
    inputs and count the calls whose result differs."""
    from semireward_tpu_torch.algorithms import common as C

    orig = C.flex_mask

    def flex_mask(state, probs, idx_ulb, p_cutoff, thresh_warmup=True):
        new, mask = orig(state, probs, idx_ulb, p_cutoff, thresh_warmup)
        log["selected"].append(new.selected_label.to(
            "cpu", torch.int16).numpy())
        if probs.device.type != "cpu":
            ref, ref_mask = orig(
                C.FlexState(state.selected_label.cpu(),
                            state.classwise_acc.cpu()),
                probs.cpu(), idx_ulb.cpu(), p_cutoff, thresh_warmup)
            same = (torch.equal(ref.selected_label, new.selected_label.cpu())
                    and torch.equal(ref.classwise_acc,
                                    new.classwise_acc.cpu())
                    and torch.equal(ref_mask, mask.cpu()))
            log["checked"] += 1
            log["mismatched"] += int(not same)
        return new, mask

    C.flex_mask = flex_mask
    try:
        yield
    finally:
        C.flex_mask = orig


def _run(tr, log):
    """Train ``tr`` to its end; per step the losses into ``log``."""
    def hook(step, metrics):
        log["loss"].append((float(metrics["sup_loss"]),
                            float(metrics["unsup_loss"])))
    t0 = time.time()
    res = tr.train(step_hook=hook)
    return {"acc": res["eval/top-1-acc"], "seconds": time.time() - t0}


def _first(diff) -> int:
    """The 1-based step of the first ``True`` in ``diff``, or -1."""
    hit = np.flatnonzero(diff)
    return int(hit[0]) + 1 if hit.size else -1


def witness(algorithm: str, seed: int, iters: int, save_dir: str,
            device: str = "cuda"):
    """The three runs of one seed (the two 'card' runs on ``device``) and
    their comparison."""
    from semireward_tpu_torch.core.trainer import Trainer
    from semireward_tpu_torch.validation import golden_config

    def fresh():
        return {"selected": [], "loss": [], "checked": 0, "mismatched": 0}

    logs = {k: fresh() for k in ("cpu", "card_cpu_draws", "card")}
    out = {"algorithm": algorithm, "seed": seed, "iters": iters}

    def cfg():
        return golden_config(algorithm, iters=iters, seed=seed,
                             save_dir=save_dir)

    runs = {"cpu": ("cpu", "cpu"), "card_cpu_draws": (device, "cpu"),
            "card": (device, None)}
    for k, (dev, rng_dev) in runs.items():
        with checked_flex_updates(logs[k]):
            out[k] = _run(Trainer(cfg(), device=dev, rng_device=rng_dev),
                          logs[k])
    for k in ("card_cpu_draws", "card"):
        out[k].update(flex_updates_checked=logs[k]["checked"],
                      flex_updates_mismatched=logs[k]["mismatched"])
    a, b = logs["cpu"], logs["card_cpu_draws"]
    if a["selected"]:
        sa, sb = np.stack(a["selected"]), np.stack(b["selected"])
        out["first_selected_label_diff_step"] = _first(
            (sa != sb).any(axis=1))
    la, lb = np.array(a["loss"]), np.array(b["loss"])
    out["first_loss_diff_step"] = _first(
        (np.abs(la - lb) > 1e-3 * np.maximum(np.abs(la), 1.0)).any(axis=1))
    return out


def main(argv=None):
    import tempfile

    from semireward_tpu_torch.golden_quality import device_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--algorithm", default="flexmatch")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--out", default=None, help="also append the lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("draw_witness: no CUDA device")
    card = device_line("cuda")
    for seed in args.seeds:
        with tempfile.TemporaryDirectory() as d:
            line = json.dumps({**witness(args.algorithm, seed, args.iters, d),
                               "device": card})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    print(card)


if __name__ == "__main__":
    main()
