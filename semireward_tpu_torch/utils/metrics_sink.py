"""Metric sinks: JSONL always, TensorBoard/wandb/Aim when importable.

Copy of ``semireward_tpu/utils/metrics_sink.py`` (framework-free), which
rebuilds the reference's observability stack (TBLog core/utils/misc.py:
78-102, WANDBHook core/hooks/wandb.py:9-67, AimHook core/hooks/aim.py:
78-154): one `MetricsSink` fan-out the trainer pushes its log_dict through.
The JSONL file is the always-on machine-readable channel (the reference's
log.txt + scripts/average_log.py regex scraping becomes a json read).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsSink:
    def __init__(self, save_path: Optional[str] = None,
                 use_tensorboard: bool = False, use_wandb: bool = False,
                 use_aim: bool = False, run_name: str = "run",
                 config: Optional[dict] = None):
        self._jsonl = None
        if save_path:
            os.makedirs(save_path, exist_ok=True)
            self._jsonl = open(os.path.join(save_path, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard and save_path:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(save_path, "tb"))
            except Exception:
                self._tb = None
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project="semireward_tpu",
                                         name=run_name, config=config or {})
            except Exception:
                self._wandb = None
        self._aim = None
        if use_aim:
            try:
                import aim

                self._aim = aim.Run(experiment=run_name)
                if config:
                    self._aim["hparams"] = config
            except Exception:
                self._aim = None

    def log(self, metrics: Dict[str, float], step: int):
        if self._jsonl:
            self._jsonl.write(json.dumps(
                {"step": step, "ts": time.time(), **metrics}) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb:
            self._wandb.log(metrics, step=step)
        if self._aim:
            for k, v in metrics.items():
                self._aim.track(v, name=k, step=step)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
        if self._wandb:
            self._wandb.finish()
