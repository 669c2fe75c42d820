"""Production mesh construction (the port of ``repro.launch.mesh``).

A :class:`~repro_torch.core.engine.world.Mesh` is a shape and axis names,
no devices: rank ``r`` is its row-major position ``r``, as the device
order of ``jax.make_mesh``.  A :class:`~repro_torch.core.engine.world.World`
starts one process per position; the memory dry-run
(``repro_torch.launch.dryrun``) reads the meshes alone.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

from repro_torch.core.engine.world import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips with multi_pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_test_mesh(n_data: int = 2, n_model: int = 4) -> Mesh:
    """Small mesh for multi-rank CPU tests."""
    return Mesh((n_data, n_model), ("data", "model"))


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes that shard the batch (everything but 'model')."""
    return tuple(a for a in mesh.axis_names if a != "model")


def all_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


def axis_size(mesh: Mesh, names: Union[str, Sequence[str]]) -> int:
    if isinstance(names, str):
        names = (names,)
    return mesh.axis_size(names)
