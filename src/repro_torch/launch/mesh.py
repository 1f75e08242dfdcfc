"""Production mesh construction.

Port of ``repro/launch/mesh.py``.  A function, not a module-level
constant, so importing this module touches no device and no process
group; the dry run builds the mesh over a fake process group
(``launch/dryrun.py``), a real run over its own.
"""
from __future__ import annotations

from typing import Tuple

__all__ = ["make_production_mesh", "production_shape", "mesh_name"]


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the production mesh: 256 H100s as
    ("data", "model") = (32, 8), or 512 as ("pod", "data", "model") =
    (2, 32, 8).  "model" (tensor and expert parallelism) stays inside one
    8-GPU NVLink node; "data" and "pod" cross nodes over InfiniBand."""
    if multi_pod:
        return (2, 32, 8), ("pod", "data", "model")
    return (32, 8), ("data", "model")


def mesh_name(shape) -> str:
    return "x".join(str(n) for n in shape)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """``init_device_mesh`` over the production shape; the default process
    group must already span its 256 (or 512) ranks.

    Axes: ("data", "model") — batch over data, TP/EP over model;
    multi-pod adds "pod" (outermost; batch also shards over it).
    """
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = production_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
