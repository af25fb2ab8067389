"""Meshes of the port (``repro/launch/mesh.py``), as virtual axes on one
device.

``make_local_mesh(devices, model, pod)`` is the development mesh: ``data =
devices / (model * pod)``, axes ``("pod", "data", "model")``, or ``("data",
"model")`` when ``pod == 1``. ``make_production_mesh`` gives the
reference's production shapes, (16, 16) over ``("data", "model")`` and,
multi-pod, (2, 16, 16) over ``("pod", "data", "model")``; it serves shape
rules (``models/common.decode_layout``, the MoE padding) and is not meant
to run a model at that size.

The mesh is a :class:`~repro_torch.core.mesh.NamedMesh`: the port computes
on one card, and only the code the reference writes per shard (the
seq-sharded decodes, MoE's expert-parallel and psum paths, ``compress_pod``)
reads the axes.
"""
from __future__ import annotations

from repro_torch.core.mesh import NamedMesh


def make_production_mesh(*, multi_pod: bool = False) -> NamedMesh:
    if multi_pod:
        return NamedMesh({"pod": 2, "data": 16, "model": 16})
    return NamedMesh({"data": 16, "model": 16})


def make_local_mesh(devices: int, model: int = 1, pod: int = 1) -> NamedMesh:
    """``devices`` virtual devices as (pod,) data x model."""
    data = devices // (model * pod)
    if data * model * pod != devices or data < 1:
        raise ValueError(f"{devices} devices do not split as pod {pod} x "
                         f"data x model {model}")
    if pod > 1:
        return NamedMesh({"pod": pod, "data": data, "model": model})
    return NamedMesh({"data": data, "model": model})


def flag_mesh(devices: int, model: int = 1, pod: int = 1) -> NamedMesh | None:
    """The launchers' ``--devices``/``--model-axis``/``--pod-axis`` mesh:
    None for one device, where an axis above 1 raises ``ValueError``."""
    if devices > 1:
        return make_local_mesh(devices, model=model, pod=pod)
    if model != 1 or pod != 1:
        raise ValueError(f"--model-axis {model} / --pod-axis {pod} need "
                         f"--devices to split")
    return None
