from .rooted import RootedInstance, ratio_gradient_of_height_gradient
from .unrooted import UnrootedInstance

__all__ = ["RootedInstance", "UnrootedInstance",
           "ratio_gradient_of_height_gradient"]
