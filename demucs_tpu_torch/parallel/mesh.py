"""Process groups and the (bag, dp, tp) device mesh.

The port of `demucs_tpu/parallel/mesh.py`. The JAX package drives every
device of a host from one process; the port runs one process per card
(a rank), joined by `torch.distributed`, and lays the ranks out on a
`DeviceMesh` with the JAX package's axes, tp innermost, so that a tensor
parallel group holds neighbouring ranks (one host's cards), and bag
outermost, so that each model of the fine-tuned bag lives on a
contiguous group of ranks:

  * ``bag``: one group of ranks per model group of the bag;
  * ``dp``:  data parallel, the segment batch (or training batch) split;
  * ``tp``:  tensor parallel, the transformer's heads and hidden units
    split (`parallel/sharding.py`), with all-reduces after the
    row-parallel products (`ops/attention.py`).

`init_distributed` chooses the backend from the device, NCCL for CUDA and
gloo for the CPU, unless the caller names one: two ranks that share one
card (a correctness run on a one-card machine) need gloo, since NCCL
refuses two ranks on one device. Nothing switches backends on its own.
"""

from __future__ import annotations

import socket

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

AXES = ("bag", "dp", "tp")
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def mesh_shape_for(n_devices: int, tp: int = 1, bag: int = 1) -> tuple[int, int, int]:
    """Factor n_devices into (bag, dp, tp); dp absorbs the remainder."""
    if n_devices % (tp * bag):
        raise ValueError(f"{n_devices} devices not divisible by tp={tp} * bag={bag}")
    return (bag, n_devices // (tp * bag), tp)


def free_port() -> int:
    """A TCP port on the loopback interface that was free a moment ago
    (bound with port 0, then released): a rendezvous address for ranks
    started on this host."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device: str | torch.device, rank: int) -> torch.device:
    """The device of `rank`: card rank % card count for "cuda", the CPU for
    "cpu". A CUDA request without a GPU raises."""
    device = resolve_device(device)
    if device.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def init_distributed(rank: int, world_size: int, init_method: str,
                     device: str | torch.device = "cuda",
                     backend: str | None = None) -> torch.device:
    """Join the default process group as `rank` of `world_size` at
    `init_method` ("tcp://HOST:PORT"), with `backend` or, by default, the
    device's (NCCL for "cuda", gloo for "cpu"); returns the rank's device
    (`rank_device`), made the current CUDA device."""
    device = rank_device(device, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend or BACKENDS[device.type], init_method=init_method,
                            rank=rank, world_size=world_size)
    return device


def _host() -> str:
    return socket.gethostname()


def make_mesh(tp: int = 1, bag: int = 1, device_type: str = "cuda"):
    """A (bag, dp, tp) DeviceMesh over every rank of the default process
    group, which must be initialized. Ranks are numbered host by host and
    tp is innermost, so each tp group is tp consecutive ranks; with tp > 1
    every one of them must be on one host, so that the tensor parallel
    all-reduces never cross hosts (bag and dp groups, with no collective
    inside a model call, may span them)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    shape = mesh_shape_for(world, tp=tp, bag=bag)
    if tp > 1:
        hosts = [None] * world
        dist.all_gather_object(hosts, _host())
        if any(len(set(hosts[i:i + tp])) > 1 for i in range(0, world, tp)):
            raise ValueError(f"tp={tp} groups would cross hosts (ranks' hosts: {hosts})")
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    """The size of `axis` of `mesh`; 1 without a mesh."""
    return 1 if mesh is None else mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along `axis`; 0 without a mesh."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """This rank's process group along `axis`; None without a mesh or
    where the axis has one rank (nothing to communicate)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)
