"""libsbn_tpu_torch: libsbn_tpu ported to PyTorch and CUDA.

The second package beside ``libsbn_tpu`` (the JAX reference, which it never
imports): the same host layer (parsing, site patterns, schedules, the SBN
support and sampler), the same JC69 and GTR likelihood, branch- and
model-gradient paths for unrooted trees, and the VBPI trainer
(``vi.JitVBPI``), with hand-written CUDA kernels for NVIDIA Hopper
(``csrc/``, built with nvcc at first use) and plain PyTorch twins of those
kernels that run on the CPU.

Nothing here sets global state at import: dtypes and devices are explicit
on every constructor, and the CPU is the default device.
"""

__version__ = "0.1.0"

from .core.tree import UnrootedTree, UnrootedTreeCollection  # noqa: E402
from .instance import UnrootedInstance  # noqa: E402
from .models.phylo_model import PhyloModelSpec  # noqa: E402

# The reference's module names (pylibsbn.cpp), as libsbn_tpu exposes them.
unrooted_instance = UnrootedInstance
PhyloModelSpecification = PhyloModelSpec

__all__ = [
    "UnrootedInstance",
    "PhyloModelSpec",
    "PhyloModelSpecification",
    "unrooted_instance",
    "UnrootedTree",
    "UnrootedTreeCollection",
    "__version__",
]
