"""Imbalanced-SSL wrappers of the port (port of ``semireward_tpu/imb``):
saw, debiaspl, adsh, abc, tras, darp, daso, crest / crest+ and cossl,
registered in ``IMB_ALGORITHMS``. Each wraps an instance of a base
algorithm: ``get_imb_algorithm(name)(cfg, data_info, device,
base_cls=ALGORITHMS.get(cfg.algorithm))``."""
from __future__ import annotations

from semireward_tpu_torch.imb import abc  # noqa: F401
from semireward_tpu_torch.imb import adsh  # noqa: F401
from semireward_tpu_torch.imb import cossl  # noqa: F401
from semireward_tpu_torch.imb import crest  # noqa: F401
from semireward_tpu_torch.imb import darp  # noqa: F401
from semireward_tpu_torch.imb import daso  # noqa: F401
from semireward_tpu_torch.imb import debiaspl  # noqa: F401
from semireward_tpu_torch.imb import saw  # noqa: F401
from semireward_tpu_torch.imb import tras  # noqa: F401
from semireward_tpu_torch.registry import IMB_ALGORITHMS


def get_imb_algorithm(name: str):
    return IMB_ALGORITHMS.get(name)
