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

The collectives are methods of a group object.  On one process
(``ThreadGroup``) each rank posts its tensor into a slot, the ranks meet
at a barrier, and each copies what it receives onto its device; a second
barrier guards the slots' reuse.  Every worker runs on its device's
default stream, so on one card the stream orders a copy after the work
that produced its source.  After ``parallel.dist.init_distributed`` a mesh
spans processes (``ProcessGroup``): each process runs the threads of its
own shards, which meet as above, and one of them makes the inter-process
``torch.distributed`` call.  A worker that raises aborts the barrier, so
the others fail at their next collective, and ``Mesh.run`` raises the
first error in the caller; on a mesh that spans processes it also leaves
the process group, so the other processes fail too.  There each collective
of ``Ctx`` is a ``psac.comm`` span of the tracer (``utils/timers.py``;
attributes ``op`` and ``bytes``, the counter ``comm_bytes``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import torch
import torch.distributed as dist

from psac_tpu_torch.parallel import dist as dist_mod
from psac_tpu_torch.utils import timers


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
    """A block-distributed array of ``p`` shards, of which this process
    holds ``shards``: the blocks of global shards ``first``, ``first + 1``,
    ... (all p of them on a mesh of one process), each (s, ...) tensor on
    its shard's device."""

    def __init__(self, shards, first: int = 0, p: int | None = None):
        self.shards = list(shards)
        self.first = first
        self.p = len(self.shards) if p is None else p

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def __len__(self) -> int:
        """The rows this process holds (all of them on one process)."""
        return sum(t.shape[0] for t in self.shards)

    def map(self, fn) -> "Sharded":
        """``fn`` applied to each local block, as an array of the same
        shards."""
        return type(self)([fn(t) for t in self.shards], self.first, self.p)

    def gather(self) -> torch.Tensor:
        """The whole array as one CPU tensor.  Raises where other
        processes hold some of its blocks (as ``jax.device_get`` of an
        array that is not fully addressable): ``parallel.dist.
        process_allgather`` is the collective that gathers those."""
        if len(self.shards) != self.p:
            raise ValueError(f"gather() of an array whose {self.p} shards "
                             f"span processes (this one holds "
                             f"{len(self.shards)}); use parallel.dist."
                             f"process_allgather")
        return torch.cat([t.cpu() for t in self.shards])

    def __repr__(self):
        return (f"Sharded(p={self.p}, first={self.first}, local={len(self)}, "
                f"dtype={self.dtype}, "
                f"devices={[str(t.device) for t in self.shards]})")


class Replicated(Sharded):
    """A replicated array held as one copy per local shard, each on its
    shard's device (the JAX ``P()`` that a shard function reads):
    ``Mesh.run`` hands shard r its copy, as it does a ``Sharded`` block."""

    def __len__(self) -> int:
        return self.shards[0].shape[0]

    def gather(self) -> torch.Tensor:
        """The array (the first local copy) as a CPU tensor."""
        return self.shards[0].cpu()


class Rep:
    """Marks an output of a ``Mesh.run`` function as replicated (the JAX
    ``P()``): every rank returns the same value, and ``run`` returns the
    first local shard's after checking that the local shards agree."""

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

    def all_gather(self, ctx, x: tuple) -> tuple:
        got = self.exchange(ctx.local, x)
        return tuple(torch.stack([g[i].to(ctx.device) for g in got])
                     for i in range(len(x)))

    def ppermute(self, ctx, x: tuple, pairs) -> tuple | None:
        src = _source(pairs, ctx.rank)
        got = self.exchange(ctx.local, x)
        if src is None:
            return None
        return tuple(t.to(ctx.device, copy=True) for t in got[src])

    def all_to_all(self, ctx, buf: tuple) -> tuple:
        got = self.exchange(ctx.local, buf)
        return tuple(torch.stack([g[i][ctx.rank].to(ctx.device)
                                  for g in got]) for i in range(len(buf)))

    def abort(self) -> None:
        self._barrier.abort()

    def reset(self) -> None:
        self._slots = [None] * self.p
        self._barrier.reset()


def _source(pairs, rank: int):
    """The rank that sends to ``rank`` under ``pairs`` (None: none)."""
    src = None
    for a, b in pairs:
        if b == rank:
            src = a
    return src


def _layout(tensors) -> tuple:
    """(dtype, shape, offset, bytes) of each tensor in ``_pack``'s buffer,
    each piece starting at a multiple of 8 bytes; and the buffer's
    length."""
    layout, off = [], 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        layout.append((t.dtype, tuple(t.shape), off, nb))
        off += -(-nb // 8) * 8
    return layout, off


def _pack(tensors) -> torch.Tensor:
    """Tensors as one flat uint8 buffer laid out by ``_layout``."""
    parts = []
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        parts.append(b)
        if b.numel() % 8:
            parts.append(b.new_zeros(8 - b.numel() % 8))
    return torch.cat(parts) if parts else torch.empty(0, dtype=torch.uint8)


def _unpack(buf: torch.Tensor, layout) -> list:
    """The tensors that ``_pack`` laid out (``_layout``), as views of
    ``buf`` (a row of a buffer whose rows are multiples of 8 bytes
    long)."""
    return [buf[off:off + nb].view(dt).reshape(shape)
            for dt, shape, off, nb in layout]


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's memory as a flat uint8 view (what the
    backends exchange: gloo has no bool)."""
    return t.reshape(-1).view(torch.uint8)


def _nbytes(x: tuple) -> int:
    return sum(t.numel() * t.element_size() for t in x)


class ProcessGroup:
    """Collectives of the global mesh when its shards span processes: the
    collectives of ``Ctx`` give what they give on one process's thread
    mesh.  This process's L shard threads meet first (as a
    ``ThreadGroup``'s do); then the first of them makes the inter-process
    call (``torch.distributed`` on the default group, with equal shapes
    and dtypes on every rank), and the threads meet again to take their
    parts.  Each call first exchanges a signature of its operation and
    shapes, so a shape or operation that differs between shards raises
    instead of hanging; its host read counts as a readback.  Under gloo
    the tensors go through the host (one copy each way); under NCCL they
    stay on the card.  ``all_to_all`` and ``ppermute`` send each tensor
    from its own memory and receive into fresh tensors that they hand
    out as they are (with one shard a process, no copy but the one
    received), so an exchange holds its payload at most twice.  The lead
    thread counts the bytes it sends to other processes (``comm_bytes``,
    under the caller's ``psac.comm`` span)."""

    def __init__(self, devices, first: int, p: int):
        self.L, self.first, self.p = len(devices), first, p
        self.world = dist_mod.process_count()
        self.comm = dist_mod.comm_device()
        self._barrier = threading.Barrier(self.L)
        self._slots = [None] * self.L
        self._out = None

    def _meet(self, local: int, obj, lead):
        """``lead(objects of the L local threads)`` run once, by the first
        local thread; every thread returns its result."""
        if self.L == 1:
            return lead([obj])
        self._slots[local] = obj
        self._barrier.wait()
        if local == 0:
            try:
                self._out = lead(list(self._slots))
            except BaseException:
                self._barrier.abort()
                raise
        self._barrier.wait()
        return self._out

    def _check(self, op: str, slots, extra=()) -> None:
        """Raise unless every shard of the mesh calls ``op`` with the same
        shapes and dtypes (and ``extra``, the ppermute pairs)."""
        sigs = [repr((op, [(str(t.dtype), tuple(t.shape)) for t in x],
                      extra)) for x in slots]
        if any(s != sigs[0] for s in sigs):
            raise RuntimeError(f"{op}: the shards of this process call it "
                               f"with different shapes: {sigs}")
        key = dist_mod.name_key(sigs[0])
        timers.count("comm_bytes", 8 * (self.world - 1))
        got = dist_mod.all_gather_flat(torch.tensor(
            [key], dtype=torch.int64, device=self.comm))
        same = not bool((got != key).any())
        timers.readback()
        if not same:
            raise RuntimeError(f"{op}: the processes call it with different "
                               f"shapes or operations (here {sigs[0]})")

    def all_gather(self, ctx, x: tuple) -> tuple:
        def lead(slots):
            self._check("all_gather", slots)
            pieces = [torch.stack([s[i].to(self.comm) for s in slots])
                      for i in range(len(x))]
            buf, layout = _pack(pieces), _layout(pieces)[0]
            timers.count("comm_bytes", buf.numel() * (self.world - 1))
            rows = dist_mod.all_gather_flat(buf).view(self.world, -1)
            parts = [_unpack(rows[w], layout) for w in range(self.world)]
            return tuple(torch.cat([pw[i] for pw in parts])
                         for i in range(len(x)))

        return tuple(t.to(ctx.device) for t in self._meet(ctx.local, x, lead))

    def all_to_all(self, ctx, buf: tuple) -> tuple:
        L, W = self.L, self.world

        def lead(slots):
            self._check("all_to_all", slots)
            outs = [[] for _ in range(L)]
            for i in range(len(buf)):
                if L == 1:
                    # (W dest processes, cap, ...): row w goes to process w
                    send = slots[0][i].to(self.comm).contiguous()
                else:
                    # (W dest processes, L src threads, L dest threads, ...)
                    t = torch.stack([s[i].to(self.comm) for s in slots])
                    send = t.reshape((L, W, L) + tuple(t.shape[2:])) \
                        .transpose(0, 1).contiguous()
                recv = torch.empty_like(send)
                if send.numel():
                    timers.count("comm_bytes",
                                 send.numel() * send.element_size()
                                 * (W - 1) // W)
                    dist.all_to_all_single(_bytes(recv), _bytes(send))
                del send
                if L == 1:
                    outs[0].append(recv)
                    continue
                rest = tuple(recv.shape[3:])
                for ld in range(L):
                    outs[ld].append(recv[:, :, ld].reshape((W * L,) + rest))
            return [tuple(o) for o in outs]

        return tuple(t.to(ctx.device)
                     for t in self._meet(ctx.local, buf, lead)[ctx.local])

    def ppermute(self, ctx, x: tuple, pairs) -> tuple | None:
        L, first = self.L, self.first
        pairs = sorted(tuple(ab) for ab in pairs)
        T = len(x)

        def lead(slots):
            self._check("ppermute", slots, pairs)
            # each local thread's (tensors, whether they are another
            # thread's own and need a copy)
            outs, ops = [None] * L, []
            for ld in range(L):  # receives in ascending shard order
                a = _source(pairs, first + ld)
                if a is None:
                    continue
                if first <= a < first + L:
                    outs[ld] = (slots[a - first], True)
                    continue
                got = tuple(torch.empty(t.shape, dtype=t.dtype,
                                        device=self.comm)
                            for t in slots[0])
                outs[ld] = (got, False)
                ops += [dist.P2POp(dist.irecv, _bytes(t), a // L,
                                   tag=(first + ld) * T + i)
                        for i, t in enumerate(got) if t.numel()]
            # sends in ascending destination order, each tensor in turn:
            # NCCL pairs the messages between two processes in the order
            # they were posted
            for a, b in sorted(pairs, key=lambda ab: ab[1]):
                if first <= a < first + L and not first <= b < first + L:
                    sent = [t.to(self.comm).contiguous()
                            for t in slots[a - first]]
                    timers.count("comm_bytes", _nbytes(sent))
                    ops += [dist.P2POp(dist.isend, _bytes(t), b // L,
                                       tag=b * T + i)
                            for i, t in enumerate(sent) if t.numel()]
            if ops:
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
            return outs

        got = self._meet(ctx.local, x, lead)[ctx.local]
        if got is None:
            return None
        tensors, local = got
        return tuple(t.to(ctx.device, copy=local) for t in tensors)

    def abort(self) -> None:
        self._barrier.abort()

    def reset(self) -> None:
        self._slots = [None] * self.L
        self._barrier.reset()


class Ctx:
    """One shard's view of a ``Mesh.run`` call: its global ``rank``, the
    mesh size ``p``, its ``device``, its index ``local`` among this
    process's shards, and the collectives (the ``jax.lax`` collectives
    over the mesh axis).  Received tensors are copies on ``device``."""

    def __init__(self, rank: int, p: int, device: torch.device, group,
                 local: int | None = None):
        self.rank = rank
        self.p = p
        self.device = device
        self.group = group
        self.local = rank if local is None else local

    def axis_index(self) -> int:
        return self.rank

    def _comm(self, op: str, x: tuple):
        """The ``psac.comm`` span of a collective that goes through a
        ``ProcessGroup`` (timed on this shard's card), with the bytes this
        shard hands it; the null span on one process."""
        if not isinstance(self.group, ProcessGroup):
            return timers.OFF
        return timers.span("psac.comm", self.device, op=op,
                           bytes=_nbytes(x))

    def all_gather(self, x):
        """(p, ...) stack of every rank's ``x`` (a tensor, or a tuple of
        tensors exchanged together: one meeting of the ranks)."""
        return self._all_gather(x, "all_gather")

    def _all_gather(self, x, op: str):
        if not isinstance(x, tuple):
            return self._all_gather((x,), op)[0]
        if self.p == 1:
            return tuple(torch.stack([t.to(self.device)]) for t in x)
        with self._comm(op, x):
            return self.group.all_gather(self, x)

    def ppermute(self, x, pairs):
        """``x`` (a tensor or a tuple of tensors) of the rank that sends
        here under ``pairs`` ((src, dst) tuples); zeros where no rank does,
        as ``lax.ppermute`` gives."""
        if not isinstance(x, tuple):
            return self.ppermute((x,), pairs)[0]
        if self.p == 1:
            src = _source(pairs, self.rank)
            got = None if src is None else \
                tuple(t.to(self.device, copy=True) for t in x)
        else:
            with self._comm("ppermute", x):
                got = self.group.ppermute(self, x, pairs)
        if got is None:
            return tuple(torch.zeros_like(t) for t in x)
        return got

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_gather(x, "psum").sum(0, dtype=x.dtype)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_gather(x, "pmax").amax(0)

    def all_to_all(self, buf):
        """(p, cap, ...) -> (p, cap, ...): row j of the result is row
        ``rank`` of rank j's ``buf`` (a tensor, or a tuple of them)."""
        if not isinstance(buf, tuple):
            return self.all_to_all((buf,))[0]
        if self.p == 1:
            return tuple(torch.stack([t[self.rank].to(self.device)])
                         for t in buf)
        with self._comm("all_to_all", buf):
            return self.group.all_to_all(self, buf)


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


def _from_locals(outs: list, first: int = 0, p: int | None = None):
    """The structure of the first local shard's output with tensors as
    ``Sharded`` (global shards ``first`` ... of ``p``) and ``Rep`` values
    unwrapped after an equality check among the local shards."""
    o0 = outs[0]
    if isinstance(o0, Rep):
        for o in outs[1:]:
            if not _same(o0.value, o.value):
                raise AssertionError(f"replicated output differs between "
                                     f"shards: {o0.value} vs {o.value}")
        return o0.value
    if isinstance(o0, torch.Tensor):
        return Sharded(outs, first, p)
    if isinstance(o0, (tuple, list)):
        return type(o0)(_from_locals([o[i] for o in outs], first, p)
                        for i in range(len(o0)))
    if isinstance(o0, dict):
        return {k: _from_locals([o[k] for o in outs], first, p) for k in o0}
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
    """p shards: on one process, one per device of an explicit list
    (``make_mesh``); after ``parallel.dist.init_distributed``, the global
    mesh of which this process holds the contiguous run of ``len(devices)``
    shards that starts at global shard ``first``."""

    def __init__(self, devices, p: int | None = None, first: int = 0):
        self.devices = [torch.device(d) for d in devices]
        self.local = len(self.devices)
        if self.local < 1:
            raise ValueError("a mesh needs at least one device")
        self.p = self.local if p is None else p
        self.first = first
        #: whether other processes hold some of the shards
        self.multiprocess = self.p != self.local
        self._group = ProcessGroup(self.devices, first, self.p) \
            if self.multiprocess else ThreadGroup(self.local)
        self._failed = None
        self._jobs: list[queue.Queue] = []
        self._done: queue.Queue = queue.Queue()
        self._lock = threading.Lock()

    def __repr__(self):
        return (f"Mesh(p={self.p}, first={self.first}, "
                f"devices={[str(d) for d in self.devices]})")

    def _start(self) -> None:
        if self._jobs:
            return
        if any(d.type == "cuda" for d in self.devices):
            # one nvcc build in the caller, never p racing ones in workers
            from psac_tpu_torch.ops import cuda_lib
            cuda_lib.lib()
        for r in range(self.local):
            q: queue.Queue = queue.Queue()
            self._jobs.append(q)
            threading.Thread(target=self._worker, args=(r, q), daemon=True,
                             name=f"psac-shard-{self.first + r}").start()

    def _worker(self, local: int, jobs: queue.Queue) -> None:
        dev = self.devices[local]
        if dev.type == "cuda":
            # the CUDA current device is per thread: launches and the
            # current stream follow it
            torch.cuda.set_device(dev)
        ctx = Ctx(self.first + local, self.p, dev, self._group, local)
        while True:
            job = jobs.get()
            if job is None:
                return
            fn, args, span = job
            try:
                # the caller's open span: this shard's spans nest under it
                with timers.adopt(span, ctx.rank):
                    out = (True, fn(ctx, *args))
            except BaseException as e:  # noqa: BLE001 - handed to the caller
                self._group.abort()
                out = (False, e)
            self._done.put((local, out))

    def _fail(self, err: BaseException) -> None:
        """After a shard's error on a mesh that spans processes: leave the
        process group, so that the other processes fail at their next
        collective (when this process ends, or at the group's timeout)
        instead of waiting for this one."""
        if self.multiprocess:
            self._failed = err
            dist_mod.shutdown()

    def run(self, fn, *args):
        """``fn(ctx, *local_args)`` on every local shard; returns the
        outputs with tensors as ``Sharded`` and ``Rep`` values as
        themselves.  With one local shard ``fn`` runs in the caller's
        thread (with the process group when the mesh spans processes)."""
        if self._failed is not None:
            raise RuntimeError("this mesh left its process group after an "
                               f"error: {self._failed!r}")
        if self.local == 1:
            ctx = Ctx(self.first, self.p, self.devices[0],
                      self._group if self.p > 1 else None, 0)
            try:
                out = fn(ctx, *_to_local(args, 0))
            except BaseException as e:
                self._fail(e)
                raise
            return _from_locals([out], self.first, self.p)
        span = timers.current()
        with self._lock:
            self._start()
            for r in range(self.local):
                self._jobs[r].put((fn, _to_local(args, r), span))
            results = [None] * self.local
            for _ in range(self.local):
                local, out = self._done.get()
                results[local] = out
            errors = [o[1] for o in results if not o[0]]
            if errors:
                self._group.reset()
                # the raising shard's error, not the others' broken barrier
                broken = threading.BrokenBarrierError
                err = next((e for e in errors if not isinstance(e, broken)),
                           errors[0])
                self._fail(err)
                raise err
        return _from_locals([o[1] for o in results], self.first, self.p)

    def close(self) -> None:
        """Stop the worker threads (they are daemons: a process that ends
        stops them too)."""
        with self._lock:
            for q in self._jobs:
                q.put(None)
            self._jobs = []

    def shard(self, x: torch.Tensor) -> Sharded:
        """The local blocks of a length-N tensor (N a multiple of p) that
        every process holds whole, each copied to its shard's device (the
        ``device_put`` of a host array onto the mesh)."""
        s = x.shape[0] // self.p
        if s * self.p != x.shape[0]:
            raise ValueError(f"length {x.shape[0]} is not a multiple of "
                             f"p = {self.p}")
        return Sharded([x[(self.first + r) * s:(self.first + r + 1) * s]
                        .to(d, copy=True) for r, d in enumerate(self.devices)],
                       self.first, self.p)

    def replicate(self, x: torch.Tensor) -> Replicated:
        """``x`` on every local shard's device (shards on one device share
        one copy: a replicated array is only read)."""
        return Replicated([x.to(d) for d in self.devices], self.first, self.p)


def make_mesh(p: int, devices=None) -> Mesh:
    """A mesh of ``p`` shards.  On one process: on ``devices`` when given
    (a list of p devices, repeats allowed: ``["cuda:0"] * 4``, ``["cpu"] *
    8``), else on the first p CUDA cards.  After
    ``parallel.dist.init_distributed`` (several processes): the global
    mesh of p shards, this process holding p / process_count of them, the
    contiguous run that process order gives it (as JAX orders a global
    mesh's devices); ``devices`` then names the local ones (default: all
    on this process's card, ``cuda:<local rank>``).  Raises when a card is
    missing, when the process count does not divide p, and under NCCL when
    a local shard is not on this process's card: the device is never
    guessed."""
    world = dist_mod.process_count()
    if world > 1:
        if p % world:
            raise ValueError(f"make_mesh({p}): {world} processes do not "
                             f"divide {p} shards")
        local = p // world
        if devices is None:
            devices = [dist_mod.local_device()] * local
        devices = [torch.device(d) for d in devices]
        if len(devices) != local:
            raise ValueError(f"make_mesh({p}): {len(devices)} local devices "
                             f"given, {local} shards per process")
        if dist_mod.backend() == "nccl" and any(
                d != dist_mod.local_device() for d in devices):
            raise ValueError(f"make_mesh({p}): under nccl every local shard "
                             f"lies on {dist_mod.local_device()}")
        return Mesh(devices, p, dist_mod.process_index() * local)
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
