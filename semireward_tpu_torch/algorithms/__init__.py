"""SSL algorithms of the port, registered under the JAX package's names:
fixmatch, flexmatch, srfixmatch, srflexmatch."""
from __future__ import annotations

from semireward_tpu_torch.algorithms import fixmatch  # noqa: F401
from semireward_tpu_torch.algorithms import flexmatch  # noqa: F401
from semireward_tpu_torch.algorithms import semireward  # noqa: F401
from semireward_tpu_torch.registry import ALGORITHMS


def get_algorithm(name: str):
    return ALGORITHMS.get(name)
