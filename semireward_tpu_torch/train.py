"""Training CLI of the port.

    python -m semireward_tpu_torch.train --c <yaml> [--key value ...]

Takes the same YAML files and ``--key value`` overrides as the JAX
package's ``train.py`` and trains on the first CUDA card
(``--device cpu`` runs the plain PyTorch path on the CPU). The log file,
``metrics.jsonl`` and the checkpoints go under ``save_dir/save_name``.
``--resume`` with ``--load_path <...>/latest_model.ckpt`` (a ``.pth`` name
means the ``.ckpt`` beside it) continues a run from its saved step; a
checkpoint that does not load gives a warning and a fresh start, as in the
JAX package.

Several cards: ``torchrun --nproc_per_node N -m semireward_tpu_torch.train
--c <yaml>`` trains the YAML's ``mesh_shape`` / ``mesh_axes`` over N ranks,
one card each (``parallel/mesh.py``); rank 0 writes ``log.txt``, the metrics
and the checkpoints.
"""
from __future__ import annotations

import argparse
import logging
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="semireward_tpu_torch trainer")
    p.add_argument("--c", "--config", dest="config", default=None,
                   help="YAML config (reference key names accepted)")
    p.add_argument("--device", default=None,
                   help="torch device; default: the first CUDA card")
    p.add_argument("--resume", action="store_true", default=None)
    args, unknown = p.parse_known_args(argv)
    overrides, key = {}, None
    for tok in unknown:
        if tok.startswith("--"):
            if "=" in tok:
                k, v = tok[2:].split("=", 1)
                overrides[k] = v
            else:
                key = tok[2:]
        elif key is not None:
            overrides[key] = tok
            key = None
    if args.resume is not None:
        overrides["resume"] = args.resume
    return args.config, args.device, overrides


def build_trainer(cfg, device=None, logger=None):
    """The CLI's Trainer: resumed from ``load_path`` when ``resume`` is
    set and the checkpoint exists; a load that raises leaves the fresh
    state (nothing is written before every leaf checks) and warns."""
    from semireward_tpu_torch.core.trainer import Trainer

    trainer = Trainer(cfg, device=device, logger=logger)
    path = cfg.load_path.replace(".pth", ".ckpt") if cfg.load_path else ""
    if cfg.resume and path and os.path.exists(path):
        try:
            trainer.load(path)
        except Exception as e:  # the reference's fresh start on failure
            trainer.logger.warning(f"resume failed ({e}); fresh start",
                                   exc_info=True)
    return trainer


def main(argv=None):
    config_path, device, overrides = parse_args(argv)
    from semireward_tpu_torch import config as config_lib

    cfg = (config_lib.from_yaml(config_path, overrides) if config_path
           else config_lib.from_dict(overrides))
    save_path = os.path.join(cfg.save_dir, cfg.save_name)
    os.makedirs(save_path, exist_ok=True)
    handlers = [logging.StreamHandler()]
    if int(os.environ.get("RANK", "0")) == 0:  # torchrun's rank
        handlers.append(logging.FileHandler(os.path.join(save_path,
                                                         "log.txt")))
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s", handlers=handlers)
    logger = logging.getLogger(f"semireward_tpu_torch.{cfg.save_name}")
    logger.info(f"algorithm={cfg.algorithm} net={cfg.net} "
                f"dataset={cfg.dataset} num_labels={cfg.num_labels} "
                f"iters={cfg.num_train_iter}")
    results = build_trainer(cfg, device, logger).train()
    for k, v in sorted(results.items()):
        logger.info(f"{k}: {v}")
    return results


if __name__ == "__main__":
    main()
