"""Mesh construction over the initialized process group, counterpart of
``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
process group (``torch.distributed.device_mesh.init_device_mesh`` needs
one, and the tests import every module).

Axis usage under the default ``dp_tp_ep`` plan, as in the reference:

* ``pod``   -- pure data parallelism (gradient sync only; the int8
              error-feedback compression of train/compression.py targets
              it)
* ``data``  -- data parallelism + FSDP of parameter d_model dims
* ``model`` -- tensor parallelism (heads / d_ff / vocab) and *expert
              parallelism* (the paper's Sec. 3.1 model-parallel expert
              shards); the port shards parameters by the plan but runs
              only the expert parallelism (core/expert_parallel.py)

The reference's TPU v5e hardware constants have no counterpart here.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.common.device import resolve_device


def _mesh(shape: tuple[int, ...], names: tuple[str, ...],
          device) -> DeviceMesh:
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    """(data 16, model 16), or (pod 2, data 16, model 16): the process
    group must hold that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device)


def make_host_mesh(model: int = 1, device="cuda") -> DeviceMesh:
    """(data = world / model, model) over every rank of the process
    group."""
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"world size {n} does not divide into model={model}")
    return _mesh((n // model, model), ("data", "model"), device)
