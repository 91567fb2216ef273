"""Variational Bayesian phylogenetics (the counterpart of libsbn_tpu.vi and
the reference's vip package): the Burrito training loop with its branch
and scalar models, priors, optimizers, the SGD_Server rule bank,
checkpoints, the fixed-topology benchmark and the ``vip-torch`` command,
and the device VBPI step (jit_step). Every submodule is imported here, so
``libsbn_tpu_torch.vi.<module>`` is reachable from the package alone.
"""

from . import (  # noqa: F401
    benchmark, branch_models, burrito, checkpoint, cli, jit_step, optimizers,
    priors, sbn_model, scalar_models, sgd_server,
)
from .burrito import Burrito  # noqa: F401
from .jit_step import JitVBPI  # noqa: F401

__all__ = [
    "Burrito", "JitVBPI", "benchmark", "branch_models", "burrito",
    "checkpoint", "cli", "jit_step", "optimizers", "priors", "sbn_model",
    "scalar_models", "sgd_server",
]
