"""Processes of a mesh that spans several of them (the port's counterpart
of ``jax.distributed.initialize``, ``jax.process_index`` /
``jax.process_count`` and ``jax.experimental.multihost_utils``'s
``process_allgather`` and ``sync_global_devices``).

``init_distributed(backend)`` joins this process to a ``torch.distributed``
group: with no further arguments it reads the ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` that ``torchrun`` sets, so
``torchrun --nproc-per-node K script.py`` works.  The caller names the
backend; nothing here picks one:

- ``"nccl"`` keeps the exchanged tensors on the card and needs one card per
  process on the host (it raises otherwise: NCCL refuses two ranks on one
  card);
- ``"gloo"`` exchanges host copies (the CPU, or several processes sharing
  one card).

Every collective of the group has the ``timeout`` given here, so a process
whose peer died fails instead of waiting.  ``parallel.mesh.make_mesh(P)``
after ``init_distributed`` gives the global mesh of P shards, each process
holding a contiguous run of P / process_count of them.
"""

from __future__ import annotations

import hashlib
import os
from datetime import timedelta

import torch
import torch.distributed as dist

#: seconds any collective may wait for its peers
DEFAULT_TIMEOUT_S = 300.0

_STATE: dict = {}


def init_distributed(backend: str, rank: int | None = None,
                     world_size: int | None = None,
                     init_method: str | None = None,
                     timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group of ``world_size`` processes as ``rank``,
    meeting at ``init_method`` (``tcp://host:port``).  Each argument left
    None is read from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` + ``MASTER_PORT``); a missing one raises.  The host's
    process count and this process's place among them come from
    ``LOCAL_WORLD_SIZE`` / ``LOCAL_RANK`` when set, else all processes are
    taken to share this host."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl': {backend!r}")
    if dist.is_initialized():
        raise RuntimeError("init_distributed: the process group exists")
    env = os.environ
    need = []
    if rank is None:
        need.append("RANK")
    if world_size is None:
        need.append("WORLD_SIZE")
    if init_method is None:
        need += ["MASTER_ADDR", "MASTER_PORT"]
    missing = [k for k in need if k not in env]
    if missing:
        raise ValueError(f"init_distributed: {', '.join(missing)} not set; "
                         "run under torchrun or pass rank, world_size and "
                         "init_method")
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    if init_method is None:
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    local_rank = int(env.get("LOCAL_RANK", rank % local_world))
    if backend == "nccl":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < local_world:
            raise ValueError(f"nccl needs one CUDA card per process: "
                             f"{local_world} process(es) on this host, "
                             f"{have} card(s)")
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout))
    _STATE.update(backend=backend, local_rank=local_rank)


def shutdown() -> None:
    """Leave the process group (``jax.distributed.shutdown``)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.clear()


def process_count() -> int:
    """The processes of the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def backend() -> str | None:
    return _STATE.get("backend")


def local_device() -> torch.device:
    """This process's card, ``cuda:<local rank>``; raises where it does
    not exist (a device is never guessed)."""
    lr = _STATE.get("local_rank", 0)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if lr >= have:
        raise ValueError(f"no CUDA card {lr} for this process ({have} "
                         "card(s)); pass devices=")
    return torch.device("cuda", lr)


def comm_device() -> torch.device:
    """Where this process's tensors are exchanged: its card under NCCL,
    the host under gloo."""
    return local_device() if backend() == "nccl" else torch.device("cpu")


def all_gather_flat(x: torch.Tensor) -> torch.Tensor:
    """(process_count * len(x),) concatenation of every process's 1-D
    ``x`` (same length and dtype on every process, on ``comm_device()``)
    in rank order."""
    out = torch.empty(process_count() * x.numel(), dtype=x.dtype,
                      device=x.device)
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, x.contiguous())
    return out


def name_key(name: str) -> int:
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:7],
                          "little")


def barrier(name: str) -> None:
    """Wait until every process has reached ``barrier(name)``
    (``sync_global_devices``); raises when the processes arrived with
    different names."""
    if process_count() == 1:
        return
    key = name_key(name)
    got = all_gather_flat(torch.tensor([key], dtype=torch.int64,
                                       device=comm_device()))
    if bool((got != key).any()):
        raise RuntimeError(f"barrier {name!r}: the processes reached "
                           "different barriers")


def process_allgather(x) -> torch.Tensor:
    """The whole of ``x`` as one CPU tensor on every process, in shard
    order (``process_allgather(..., tiled=True)``): a ``Sharded`` array's
    blocks gathered from the processes that hold them, a ``Replicated``
    one's local copy, a tensor copied to the host.  Every process must
    call it."""
    from psac_tpu_torch.parallel.mesh import Replicated, Sharded

    if isinstance(x, Replicated):
        return x.shards[0].cpu()
    if not isinstance(x, Sharded):
        return x.cpu()
    if len(x.shards) == x.p:
        return x.gather()
    dev = comm_device()
    local = torch.cat([t.to(dev) for t in x.shards])
    flat = local.reshape(-1)
    if flat.dtype == torch.bool:
        flat = flat.view(torch.uint8)
    got = all_gather_flat(flat).cpu().view(local.dtype)
    return got.reshape((-1,) + tuple(local.shape[1:]))
