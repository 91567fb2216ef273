from .instance import GPInstance
from .subsplit_dag import SubsplitDAG

__all__ = ["GPInstance", "SubsplitDAG"]
