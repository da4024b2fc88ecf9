"""SSL algorithms of the port, registered under the JAX package's names:
fixmatch, flexmatch, freematch, softmatch, pseudolabel, supervised /
fullysupervised, and the SemiReward variants srpseudolabel, srfixmatch,
srflexmatch, srfreematch, srsoftmatch."""
from __future__ import annotations

from semireward_tpu_torch.algorithms import fixmatch  # noqa: F401
from semireward_tpu_torch.algorithms import flexmatch  # noqa: F401
from semireward_tpu_torch.algorithms import freematch  # noqa: F401
from semireward_tpu_torch.algorithms import pseudolabel  # noqa: F401
from semireward_tpu_torch.algorithms import softmatch  # noqa: F401
from semireward_tpu_torch.algorithms import semireward  # noqa: F401
from semireward_tpu_torch.registry import ALGORITHMS


def get_algorithm(name: str):
    return ALGORITHMS.get(name)
