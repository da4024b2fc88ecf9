"""SSL algorithms of the port, registered under the JAX package's names:
fixmatch, defixmatch, flexmatch, freematch, softmatch, pseudolabel,
supervised / fullysupervised, pimodel, meanteacher, vat, mixmatch,
remixmatch, uda, dash, adamatch, crmatch, comatch, simmatch, and the
SemiReward variants srpseudolabel, srfixmatch, srflexmatch, srfreematch,
srsoftmatch."""
from __future__ import annotations

from semireward_tpu_torch.algorithms import adamatch  # noqa: F401
from semireward_tpu_torch.algorithms import comatch  # noqa: F401
from semireward_tpu_torch.algorithms import crmatch  # noqa: F401
from semireward_tpu_torch.algorithms import dash  # noqa: F401
from semireward_tpu_torch.algorithms import fixmatch  # noqa: F401
from semireward_tpu_torch.algorithms import flexmatch  # noqa: F401
from semireward_tpu_torch.algorithms import freematch  # noqa: F401
from semireward_tpu_torch.algorithms import mixmatch  # noqa: F401
from semireward_tpu_torch.algorithms import pimodel  # noqa: F401
from semireward_tpu_torch.algorithms import pseudolabel  # noqa: F401
from semireward_tpu_torch.algorithms import remixmatch  # noqa: F401
from semireward_tpu_torch.algorithms import softmatch  # noqa: F401
from semireward_tpu_torch.algorithms import semireward  # noqa: F401
from semireward_tpu_torch.algorithms import simmatch  # noqa: F401
from semireward_tpu_torch.algorithms import uda  # noqa: F401
from semireward_tpu_torch.algorithms import vat  # noqa: F401
from semireward_tpu_torch.registry import ALGORITHMS


def get_algorithm(name: str):
    return ALGORITHMS.get(name)
