"""libsbn_tpu_torch: libsbn_tpu ported to PyTorch and CUDA.

The second package beside ``libsbn_tpu`` (the JAX reference, which it never
imports): the same host layer (parsing, site patterns, schedules, the SBN
support and sampler, SA and EM training), the same JC69 and GTR
likelihood, branch- and model-gradient paths for unrooted trees and rooted
time trees (``RootedInstance``), with per-tree parameter rows, the vip
layer (``vi.Burrito``, its models, optimizers, checkpoints, benchmark and
the ``vip-torch`` command) beside the device VBPI step (``vi.JitVBPI``),
generalized pruning over the subsplit DAG (``gp.GPInstance``, in memory
or streamed by pattern chunks) and forest mode (``ops.forest``), with
hand-written CUDA kernels for NVIDIA Hopper
(``csrc/``, built with nvcc at first use) and plain PyTorch twins of those
kernels that run on the CPU.

Nothing here sets global state at import. The entry points
(``prepare_for_phylo_likelihood``, ``LikelihoodEngine``,
``train_expectation_maximization``, ``vi.Burrito``,
``GPInstance.make_engine``, ``GPEngine``) compute on the CUDA card unless
the caller passes ``device="cpu"``, and raise when there is no card
(``utils/device.py``); dtypes are explicit on every constructor.
"""

__version__ = "0.1.0"

from .core.tree import (  # noqa: E402
    RootedTree, RootedTreeCollection, UnrootedTree, UnrootedTreeCollection,
)
from .gp.instance import GPInstance  # noqa: E402
from .instance import (  # noqa: E402
    RootedInstance, UnrootedInstance, ratio_gradient_of_height_gradient,
)
from .models.phylo_model import PhyloModelSpec  # noqa: E402
from .sbn.support import PSPIndexer  # noqa: E402

# The reference's module names (pylibsbn.cpp), as libsbn_tpu exposes them.
rooted_instance = RootedInstance
unrooted_instance = UnrootedInstance
gp_instance = GPInstance
PhyloModelSpecification = PhyloModelSpec

__all__ = [
    "RootedInstance",
    "UnrootedInstance",
    "PhyloModelSpec",
    "PhyloModelSpecification",
    "rooted_instance",
    "unrooted_instance",
    "ratio_gradient_of_height_gradient",
    "GPInstance",
    "gp_instance",
    "PSPIndexer",
    "RootedTree",
    "RootedTreeCollection",
    "UnrootedTree",
    "UnrootedTreeCollection",
    "__version__",
]
