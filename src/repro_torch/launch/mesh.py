"""Production mesh construction: the port of the JAX package's
``launch/mesh.py``, on ``torch.distributed.device_mesh``.

Functions, never module-level meshes, so that importing this module
touches no process group.  A ``DeviceMesh`` spans processes, one a
device, so a mesh needs a process group of its size first:

* ``make_production_mesh`` builds ``(16, 16) ("data", "model")`` or, with
  ``multi_pod``, ``(2, 16, 16) ("pod", "data", "model")`` over the group
  that exists — 256 or 512 processes on the cards, or the placeholder
  group of ``fake_process_group`` for the dry-run, whose tensors live on
  the ``meta`` device;
* ``make_local_mesh(data, model)`` builds a small mesh over the processes
  that exist (tests, examples), and brings up a one-process group first
  when there is none and the mesh is 1 × 1.

The hardware model of the roofline is the H100's, per card: the bf16
dense peak and the HBM rate of ``kernels/bounds.py``, and ``LINK_BW``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels.bounds import HBM_BYTES_PER_S, PEAK_FLOPS

#: bf16 dense FLOP/s and HBM bytes/s of one H100 SXM at 700 W
PEAK_FLOPS_BF16 = PEAK_FLOPS["bfloat16"]
HBM_BW = HBM_BYTES_PER_S
#: bytes/s per card on the slowest link a collective of the production
#: mesh crosses.  A 16-wide ``model`` axis spans two 8-card NVLink nodes,
#: so its rings leave the node through each card's own ConnectX-7 NIC:
#: 400 Gb/s NDR InfiniBand, 50e9 B/s (NVIDIA DGX H100 user guide: eight
#: 400 Gb/s compute ports, one a card).  The ``data`` and ``pod`` axes
#: cross nodes too.  NVLink (450e9 B/s a direction) is not the limit.
LINK_BW = 50e9


def fake_process_group(world_size: int) -> None:
    """Bring up the placeholder process group of ``world_size`` ranks in
    this one process (rank 0; collectives return at once and move
    nothing): the dry-run's stand-in for a cluster.  A group already up
    of that size is kept; one of another size is an error."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()}"
                               f" ranks is up, not {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _mesh(device_type: str, shape, names):
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh over the first 256 (512) ranks of the process
    group that is up: the cards', or ``fake_process_group``'s for the
    dry-run, whose tensors live on ``meta``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    if not dist.is_initialized() or dist.get_world_size() < n:
        raise RuntimeError(f"the production mesh {shape} needs a process "
                           f"group of {n} ranks or more "
                           "(fake_process_group for a dry-run)")
    return _mesh(device_type, shape, names)


def make_local_mesh(data: int = 1, model: int = 1,
                    device_type: str = "cuda"):
    """A ``(data, model)`` mesh over ranks ``0 .. data·model − 1`` of the
    process group that is up (tests, examples).  Without a group, a 1 × 1
    mesh brings up a one-process group (NCCL on the card, gloo on the
    CPU) over an in-process store."""
    if not dist.is_initialized():
        if data * model != 1:
            raise RuntimeError(f"a {data} x {model} mesh needs a process "
                               "group of at least that many ranks")
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    if data * model > n:
        raise RuntimeError(f"a {data} x {model} mesh needs {data * model} "
                           f"ranks, the group has {n}")
    return _mesh(device_type, (data, model), ("data", "model"))
