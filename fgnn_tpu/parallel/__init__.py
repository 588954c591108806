from .shuffler import EpochShuffler, DistShuffler, AlignedDistShuffler
from .mesh import RoleMesh, make_role_mesh, make_data_mesh


def __getattr__(name):
    # engines import lazily — keep `import fgnn_tpu.parallel` light
    if name == "FactoredEngine":
        from .factored import FactoredEngine
        return FactoredEngine
    if name == "SGNNEngine":
        from .factored import SGNNEngine
        return SGNNEngine
    if name == "SwitcherEngine":
        from .switcher import SwitcherEngine
        return SwitcherEngine
    if name == "AsyncFactoredEngine":
        from .async_dp import AsyncFactoredEngine
        return AsyncFactoredEngine
    if name == "MultihostFactoredEngine":
        from .factored_multihost import MultihostFactoredEngine
        return MultihostFactoredEngine
    raise AttributeError(name)
