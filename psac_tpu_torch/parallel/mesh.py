"""The mesh of p shards (port of ``psac_tpu/parallel/mesh.py`` and of the
``jit(shard_map(...))`` regions that run on it).

Every length-N array is distributed block-wise over the p shards of a
``Mesh``: shard r holds elements [r*s, (r+1)*s), s = N // p, as one tensor
on its own device (``Sharded``).  ``Mesh.run(fn, *args)`` is the
counterpart of ``jit(shard_map(fn))``: p persistent worker threads, one per
shard and each pinned to its shard's device, call ``fn(ctx, *local_args)``
together, and the collectives of ``ctx`` (``Ctx``: ``ppermute``,
``all_gather``, ``psum``, ``pmax``, ``all_to_all``) exchange tensors
between them.  A replicated array (the JAX ``P()``) is held as one copy
per shard on the shard's device (``Replicated``, ``Mesh.replicate``), and
a dataclass argument of ``Mesh.run`` reaches each shard with its
``Sharded`` fields replaced by the shard's block.  A mesh may put several
shards on one device (``["cuda:0"] * 4`` on a one-card machine, ``["cpu"]
* 8`` in the tests), as the JAX package's tests run on virtual CPU
devices.

The collectives are methods of a group object; the one implementation here
(``ThreadGroup``) posts each rank's tensor into a slot, meets at a barrier,
and copies what a rank receives onto its device; a second barrier guards
the slots' reuse.  Every worker runs on its device's default stream, so on
one card the stream orders a copy after the work that produced its source.
A worker that raises aborts the barrier, so the others fail at their next
collective, and ``Mesh.run`` raises the first error in the caller.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import torch


def padded_size(n: int, p: int = 1, multiple: int = 8) -> int:
    """Global padded size: divisible by p*multiple, rounded up to a
    quarter-power-of-two bucket (<= 25% padding).  N depends on p, so
    padded states compare only between meshes of one size."""
    chunk = p * multiple
    n = max(n, chunk)
    # next bucket of the form m * 2^e with m in {4, 5, 6, 7}
    e = max(0, n.bit_length() - 3)
    bucket = -(-n >> e) << e  # ceil to multiple of 2^e
    return ((bucket + chunk - 1) // chunk) * chunk


class Sharded:
    """A block-distributed array: ``shards[r]`` is shard r's (s, ...)
    tensor, on the mesh's r-th device."""

    def __init__(self, shards):
        self.shards = list(shards)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def p(self) -> int:
        return len(self.shards)

    def __len__(self) -> int:
        return sum(t.shape[0] for t in self.shards)

    def gather(self) -> torch.Tensor:
        """The whole array as one CPU tensor."""
        return torch.cat([t.cpu() for t in self.shards])

    def __repr__(self):
        return (f"Sharded(p={self.p}, len={len(self)}, dtype={self.dtype}, "
                f"devices={[str(t.device) for t in self.shards]})")


class Replicated(Sharded):
    """A replicated array held as one copy per shard, each on its shard's
    device (the JAX ``P()`` that a shard function reads): ``Mesh.run``
    hands shard r ``shards[r]``, as it does a ``Sharded`` block."""

    def __len__(self) -> int:
        return self.shards[0].shape[0]

    def gather(self) -> torch.Tensor:
        """The array (shard 0's copy) as a CPU tensor."""
        return self.shards[0].cpu()


class Rep:
    """Marks an output of a ``Mesh.run`` function as replicated (the JAX
    ``P()``): every rank returns the same value, and ``run`` returns rank
    0's after checking that all agree."""

    def __init__(self, value):
        self.value = value


class ThreadGroup:
    """Collectives among the p worker threads of one mesh: each call posts
    a rank's object into its slot and meets the others at a barrier."""

    def __init__(self, p: int):
        self.p = p
        self._slots = [None] * p
        self._barrier = threading.Barrier(p)

    def exchange(self, rank: int, obj) -> list:
        """Every rank's ``obj``, in rank order (the objects themselves: a
        caller copies what it keeps)."""
        self._slots[rank] = obj
        self._barrier.wait()
        got = list(self._slots)
        self._barrier.wait()  # no rank overwrites a slot still being read
        return got

    def abort(self) -> None:
        self._barrier.abort()

    def reset(self) -> None:
        self._slots = [None] * self.p
        self._barrier.reset()


class Ctx:
    """One shard's view of a ``Mesh.run`` call: its ``rank``, the mesh
    size ``p``, its ``device``, and the collectives (the ``jax.lax``
    collectives over the mesh axis).  Received tensors are copies on
    ``device``."""

    def __init__(self, rank: int, p: int, device: torch.device, group):
        self.rank = rank
        self.p = p
        self.device = device
        self.group = group

    def axis_index(self) -> int:
        return self.rank

    def _exchange(self, x):
        return self.group.exchange(self.rank, x)

    def all_gather(self, x):
        """(p, ...) stack of every rank's ``x`` (a tensor, or a tuple of
        tensors exchanged together: one meeting of the ranks)."""
        if isinstance(x, tuple):
            got = [x] if self.p == 1 else self._exchange(x)
            return tuple(torch.stack([g[i].to(self.device) for g in got])
                         for i in range(len(x)))
        return self.all_gather((x,))[0]

    def ppermute(self, x, pairs):
        """``x`` (a tensor or a tuple of tensors) of the rank that sends
        here under ``pairs`` ((src, dst) tuples); zeros where no rank does,
        as ``lax.ppermute`` gives."""
        if not isinstance(x, tuple):
            return self.ppermute((x,), pairs)[0]
        src = None
        for a, b in pairs:
            if b == self.rank:
                src = a
        got = [x] if self.p == 1 else self._exchange(x)
        if src is None:
            return tuple(torch.zeros_like(t) for t in x)
        return tuple(t.to(self.device, copy=True) for t in got[src])

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_gather(x).sum(0, dtype=x.dtype)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_gather(x).amax(0)

    def all_to_all(self, buf):
        """(p, cap, ...) -> (p, cap, ...): row j of the result is row
        ``rank`` of rank j's ``buf`` (a tensor, or a tuple of them)."""
        if not isinstance(buf, tuple):
            return self.all_to_all((buf,))[0]
        got = [buf] if self.p == 1 else self._exchange(buf)
        return tuple(torch.stack([g[i][self.rank].to(self.device)
                                  for g in got]) for i in range(len(buf)))


def _to_local(obj, rank: int):
    if isinstance(obj, Sharded):
        return obj.shards[rank]
    if isinstance(obj, tuple):
        return tuple(_to_local(o, rank) for o in obj)
    if isinstance(obj, list):
        return [_to_local(o, rank) for o in obj]
    if isinstance(obj, dict):
        return {k: _to_local(v, rank) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = {f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(obj) if f.init}
        local = {k: _to_local(v, rank) for k, v in fields.items()}
        if all(local[k] is v for k, v in fields.items()):
            return obj
        return dataclasses.replace(obj, **local)
    return obj


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu(), b.cpu())
    return a == b


def _from_locals(outs: list):
    """The structure of rank 0's output with tensors as ``Sharded`` and
    ``Rep`` values unwrapped after an equality check."""
    o0 = outs[0]
    if isinstance(o0, Rep):
        for o in outs[1:]:
            if not _same(o0.value, o.value):
                raise AssertionError(f"replicated output differs between "
                                     f"shards: {o0.value} vs {o.value}")
        return o0.value
    if isinstance(o0, torch.Tensor):
        return Sharded(outs)
    if isinstance(o0, (tuple, list)):
        return type(o0)(_from_locals([o[i] for o in outs])
                        for i in range(len(o0)))
    if isinstance(o0, dict):
        return {k: _from_locals([o[k] for o in outs]) for k in o0}
    return o0


def _unrep(obj):
    """``obj`` with every ``Rep`` replaced by its value."""
    if isinstance(obj, Rep):
        return obj.value
    if isinstance(obj, (tuple, list)):
        return type(obj)(_unrep(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _unrep(v) for k, v in obj.items()}
    return obj


def run_on(mesh, fn, *args):
    """``mesh.run(fn, *args)``; without a mesh (one device) ``fn(None,
    *args)`` in the caller's thread, its tensors as they are and its
    ``Rep`` values unwrapped.  A shard function takes ``ctx=None`` as the
    one shard of a one-device build (the collectives' p = 1 forms)."""
    if mesh is None:
        return _unrep(fn(None, *args))
    return mesh.run(fn, *args)


class Mesh:
    """p shards on an explicit list of devices (``make_mesh``)."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self.p = len(self.devices)
        if self.p < 1:
            raise ValueError("a mesh needs at least one device")
        self._group = ThreadGroup(self.p)
        self._jobs: list[queue.Queue] = []
        self._done: queue.Queue = queue.Queue()
        self._lock = threading.Lock()

    def __repr__(self):
        return f"Mesh(p={self.p}, devices={[str(d) for d in self.devices]})"

    def _start(self) -> None:
        if self._jobs:
            return
        if any(d.type == "cuda" for d in self.devices):
            # one nvcc build in the caller, never p racing ones in workers
            from psac_tpu_torch.ops import cuda_lib
            cuda_lib.lib()
        for r in range(self.p):
            q: queue.Queue = queue.Queue()
            self._jobs.append(q)
            threading.Thread(target=self._worker, args=(r, q), daemon=True,
                             name=f"psac-shard-{r}").start()

    def _worker(self, rank: int, jobs: queue.Queue) -> None:
        dev = self.devices[rank]
        if dev.type == "cuda":
            # the CUDA current device is per thread: launches and the
            # current stream follow it
            torch.cuda.set_device(dev)
        ctx = Ctx(rank, self.p, dev, self._group)
        while True:
            job = jobs.get()
            if job is None:
                return
            fn, args = job
            try:
                out = (True, fn(ctx, *args))
            except BaseException as e:  # noqa: BLE001 - handed to the caller
                self._group.abort()
                out = (False, e)
            self._done.put((rank, out))

    def run(self, fn, *args):
        """``fn(ctx, *local_args)`` on every shard; returns the outputs
        with tensors as ``Sharded`` and ``Rep`` values as themselves.  At
        p = 1 ``fn`` runs in the caller's thread."""
        if self.p == 1:
            return _from_locals([fn(Ctx(0, 1, self.devices[0], None),
                                    *_to_local(args, 0))])
        with self._lock:
            self._start()
            for r in range(self.p):
                self._jobs[r].put((fn, _to_local(args, r)))
            results = [None] * self.p
            for _ in range(self.p):
                rank, out = self._done.get()
                results[rank] = out
            errors = [o[1] for o in results if not o[0]]
            if errors:
                self._group.reset()
                # the raising shard's error, not the others' broken barrier
                broken = threading.BrokenBarrierError
                raise next((e for e in errors if not isinstance(e, broken)),
                           errors[0])
        return _from_locals([o[1] for o in results])

    def close(self) -> None:
        """Stop the worker threads (they are daemons: a process that ends
        stops them too)."""
        with self._lock:
            for q in self._jobs:
                q.put(None)
            self._jobs = []

    def shard(self, x: torch.Tensor) -> Sharded:
        """Split a length-N tensor (N a multiple of p) into p blocks, each
        copied to its shard's device."""
        s = x.shape[0] // self.p
        if s * self.p != x.shape[0]:
            raise ValueError(f"length {x.shape[0]} is not a multiple of "
                             f"p = {self.p}")
        return Sharded([x[r * s:(r + 1) * s].to(d, copy=True)
                        for r, d in enumerate(self.devices)])

    def replicate(self, x: torch.Tensor) -> Replicated:
        """``x`` on every shard's device (shards on one device share one
        copy: a replicated array is only read)."""
        return Replicated([x.to(d) for d in self.devices])


def make_mesh(p: int, devices=None) -> Mesh:
    """A mesh of ``p`` shards: on ``devices`` when given (a list of p
    devices, repeats allowed: ``["cuda:0"] * 4``, ``["cpu"] * 8``), else on
    the first p CUDA cards.  Raises when fewer than p cards exist and no
    ``devices`` are given: the device is never guessed."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < p:
            raise ValueError(f"make_mesh({p}): {have} CUDA device(s); pass "
                             f"devices= to place several shards on one "
                             f"device")
        devices = [f"cuda:{i}" for i in range(p)]
    devices = list(devices)
    if len(devices) != p:
        raise ValueError(f"make_mesh({p}): {len(devices)} devices given")
    return Mesh(devices)


def num_shards(mesh) -> int:
    """p of a mesh; 1 for None (one device)."""
    return 1 if mesh is None else mesh.p
