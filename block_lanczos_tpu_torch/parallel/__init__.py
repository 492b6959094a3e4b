"""The mesh: the three fields' solvers on a grid of torch.distributed ranks.

The port of the JAX package's parallel/ (see each module): mesh.py (the
grid and its row and column groups), sharding.py (band maps and each
rank's block), collectives.py (the exact all-reduces, hand-written CUDA
kernels around the transport's sum), multihost.py (joining the world,
whole blocks in and out), distributed.py, distributed_wide.py and
distributed_gf2.py (the sharded solvers), launch.py (spawning local ranks).
Exports load lazily: importing the package starts nothing.
"""

_EXPORTS = {
    "Grid": "mesh", "make_grid": "mesh", "make_mesh": "mesh",
    "balanced_grid": "mesh",
    "ShardedBlockLanczos": "distributed",
    "ShardedBlockLanczosWide": "distributed_wide",
    "ShardedBlockLanczosGF2": "distributed_gf2",
    "spawn": "launch",
}


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


__all__ = list(_EXPORTS)
