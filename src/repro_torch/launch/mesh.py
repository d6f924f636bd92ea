"""Serving meshes (port of ``repro/launch/mesh.py``).

Every builder is a function: importing this module touches no process
group. A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the default process group, one rank a process (``torchrun``
starts them and sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``); NCCL on CUDA, gloo on the CPU. A single process with no
such environment gets a one-rank group over an in-memory store, so a 1x1
mesh needs no network.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["make_production_mesh", "make_local_mesh", "parse_mesh_spec",
           "mesh_from_spec", "init_ranks"]


def init_ranks(device: DeviceLike = None,
               timeout_s: float = 600.0) -> None:
    """Start the default process group if it is not up: NCCL for a CUDA
    ``device``, gloo for the CPU, ranks from ``torchrun``'s environment,
    or one rank over a ``HashStore`` when there is none. On CUDA the
    rank's card is ``LOCAL_RANK``'s. Raises when the group does not come
    up: there is no fallback to single-rank serving."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """The reference's production shape: 16x16 (data, model), or
    2x16x16 (pod, data, model) with ``multi_pod``. Raises unless the
    default group has exactly that many ranks."""
    import torch.distributed as dist
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs {need} ranks "
            f"(torchrun --nproc-per-node ... across the hosts); the "
            f"process group has {have}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def make_local_mesh(data: int = 1, model: int = 1,
                    device: DeviceLike = None):
    """A (data, model) mesh over the default group's ranks, which must
    number ``data * model`` (the group is started if it is not up)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data} "
                         f"model={model}")
    dev = resolve_device(device)
    init_ranks(dev)
    world = dist.get_world_size()
    if data * model != world:
        raise RuntimeError(f"a {data}x{model} mesh needs {data * model} "
                           f"ranks, the process group has {world}")
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))


def parse_mesh_spec(spec: str) -> dict:
    """``"data=2,model=4"`` -> ``{"data": 2, "model": 4}``. Unknown axes
    are refused, so a typo cannot quietly serve unsharded."""
    out = {"data": 1, "model": 1}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            axis, _, val = part.partition("=")
            n = int(val)
        except ValueError:
            raise ValueError(f"bad mesh spec part {part!r} in {spec!r} "
                             f"(expected axis=N)") from None
        if axis not in out:
            raise ValueError(f"unknown mesh axis {axis!r} in {spec!r} "
                             f"(serving meshes have data/model)")
        if n < 1:
            raise ValueError(f"mesh axis {axis} must be >= 1, got {n}")
        out[axis] = n
    return out


def mesh_from_spec(spec, device: DeviceLike = None) -> Optional[object]:
    """``--mesh`` string (or dict) to a local serving mesh; None, empty or
    1x1 gives None (the single-rank engine), as in the reference."""
    if not spec:
        return None
    axes = parse_mesh_spec(spec) if isinstance(spec, str) else dict(spec)
    if axes.get("data", 1) == 1 and axes.get("model", 1) == 1:
        return None
    return make_local_mesh(axes["data"], axes["model"], device)
