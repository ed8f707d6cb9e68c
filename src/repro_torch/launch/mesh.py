"""The (data, model) process grid over ``torch.distributed`` (port of
``repro.launch.mesh``).

:func:`make_mesh` lays the default group's ranks out row-major, ``rank =
d · M + m`` (the order ``jax.make_mesh`` gives host devices), and makes a
data group per model coordinate (the D ranks that hold the same model
shards) and a model group per data coordinate (the M ranks that split one
replica).  The caller creates the default group first: NCCL for the card,
gloo for the CPU, as for the data-only step.

The reference's ``make_production_mesh`` (a 16 × 16 TPU pod and its
2 × 16 × 16 two-pod form) is not ported: its shapes are a pod's, not a
card host's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch.distributed as tdist

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on a (data, model) grid of processes.

    ``shape`` is ``{"data": D, "model": M}``; ``rank`` the rank in the
    default group; ``data_group`` the ranks of this model coordinate (what
    a data-axis collective spans) and ``model_group`` the ranks of this data
    coordinate (what a model-axis collective spans)."""

    shape: Dict[str, int]
    rank: int
    data_group: Any
    model_group: Any
    axis_names: Tuple[str, ...] = AXES

    @property
    def coord(self) -> Tuple[int, int]:
        """This rank's ``(data, model)`` coordinate."""
        return divmod(self.rank, self.shape["model"])

    @property
    def coords(self) -> Dict[str, Tuple[int, int]]:
        """``{axis: (index, size)}`` for :func:`repro_torch.sharding.
        shard_tree`."""
        d, m = self.coord
        return {"data": (d, self.shape["data"]), "model": (m, self.shape["model"])}


def make_mesh(shape: Tuple[int, int]) -> Mesh:
    """A ``(D, M)`` grid over the default process group, whose size must be
    D · M.  Every rank makes every subgroup, in the same order, those it is
    not in too (``torch.distributed.new_group`` is collective)."""
    d_size, m_size = (int(s) for s in shape)
    world, rank = tdist.get_world_size(), tdist.get_rank()
    if d_size * m_size != world:
        raise ValueError(f"a ({d_size}, {m_size}) mesh needs {d_size * m_size} "
                         f"processes, the group has {world}")
    grid = np.arange(world).reshape(d_size, m_size)
    data_group = model_group = None
    for m in range(m_size):
        ranks = [int(r) for r in grid[:, m]]
        g = tdist.new_group(ranks)
        if rank in ranks:
            data_group = g
    for d in range(d_size):
        ranks = [int(r) for r in grid[d]]
        g = tdist.new_group(ranks)
        if rank in ranks:
            model_group = g
    return Mesh(shape={"data": d_size, "model": m_size}, rank=rank,
                data_group=data_group, model_group=model_group)


def make_test_mesh() -> Mesh:
    """The (2, 2) grid of the tests (four processes)."""
    return make_mesh((2, 2))


def cli_shape(world: int) -> Tuple[int, int]:
    """The training CLI's grid for ``world`` processes, the JAX CLI's rule
    on its device count: four or more → (world/2, 2), two or three →
    (world, 1), one → (1, 1)."""
    if world >= 4:
        if world % 2:
            raise ValueError(f"{world} processes do not split into a model "
                             f"axis of 2")
        return (world // 2, 2)
    return (world, 1)


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    assert "model" in mesh.axis_names
    return "model"


def mesh_info(mesh) -> dict:
    dp = 1
    for a in data_axes(mesh):
        dp *= mesh.shape[a]
    return {
        "data_parallel": dp,
        "model_parallel": mesh.shape["model"],
        "chips": dp * mesh.shape["model"],
        "axis_names": tuple(mesh.axis_names),
    }
