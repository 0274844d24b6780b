"""The suffix-tree build across processes (psac ``psac -t`` under
``mpiexec -np p``): p processes, one shard each, build one text to SA, LCP
and the suffix-tree node table together, ``encode_and_shard`` ->
``construct_device`` -> ``construct_suffix_tree_device`` on the global
mesh of ``parallel.dist.init_distributed`` + ``make_mesh(p)``.

The runner's process is rank 0 on the run's device.  Set-up builds the
kernel library once, starts ranks 1 .. p-1 as child processes of this
file with torchrun's variables, joins them in one process group (the
traffic's backend and timeout), hands every rank the text from rank 0
(checked by a digest) and runs one warm build.  Each step, rank 0
broadcasts a command; every rank stages its own block of the host
``bytes``, builds, and meets the others at a barrier, so a step ends when
the last rank is done.  The previous build's index is dropped before the
next starts.  The outputs are the last build's real rows gathered to
rank 0's host in blocks; the facts hold every rank's peak
(``peak_bytes_rank<r>``).

Every wait is bounded: rank 0 stops the run when a worker exits before
it is released, and each phase has a deadline (``faulthandler``'s, which
needs no Python thread) past which the process ends with exit code 1; a
worker dies with rank 0 (``PR_SET_PDEATHSIG``) and has the same
deadlines."""

from __future__ import annotations

import ctypes
import dataclasses
import faulthandler
import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import torch

if __name__ == "__main__":  # a worker: the checkout's root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from psac_tpu_torch.config import SAConfig  # noqa: E402
from psac_tpu_torch.models.suffix_array import (construct_device,  # noqa
                                                encode_and_shard)
from psac_tpu_torch.models.suffix_tree import \
    construct_suffix_tree_device  # noqa: E402
from psac_tpu_torch.parallel import dist as pdist  # noqa: E402
from psac_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

REFERENCE = "index_outputs_lean"
OUTPUTS = frozenset({"sa", "lcp", "nodes"})

#: the commands rank 0 broadcasts
STOP, BUILD, FACTS, GATHER = range(4)
#: elements of one shard's array gathered to rank 0 at a time
GATHER_BLOCK = 1 << 24
#: bytes of the text broadcast at a time
TEXT_BLOCK = 1 << 26
#: the environment variable that hands a worker its cell
CELL_VAR = "PORTBENCH_SHARDED_CELL"


@dataclasses.dataclass
class State:
    text: bytes
    config: SAConfig
    device: torch.device
    mesh: object
    timeout: float
    procs: list = dataclasses.field(default_factory=list)
    watch: object = None
    last: tuple | None = None
    N: int = 0


def inputs(config: dict, traffic: dict, seed: int, device, seconds: float,
           finder) -> dict:
    spec = traffic["text"]
    return {"text": finder.module("gen", spec["gen"]).make(spec, seed,
                                                             device)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _deadline(seconds: float | None) -> None:
    """End the process (exit code 1, every thread's stack on stderr) once
    ``seconds`` pass; None disarms."""
    faulthandler.cancel_dump_traceback_later()
    if seconds is not None:
        faulthandler.dump_traceback_later(seconds, exit=True)


class _Watch:
    """Rank 0's watch over its workers: a worker that exits before
    ``release`` ends the run at once (exit code 1), as does a worker
    whose start failed."""

    def __init__(self, procs: list):
        self.procs = procs
        self.released = False
        threading.Thread(target=self._run, daemon=True,
                         name="portbench-watch").start()

    def _run(self) -> None:
        while not self.released:
            for r, p in enumerate(self.procs, start=1):
                rc = p.poll()
                if rc is not None and not self.released:
                    print(f"portbench: rank {r} exited with code {rc} "
                          "during the run", file=sys.stderr, flush=True)
                    kill(self.procs)
                    os._exit(1)
            time.sleep(0.2)


def kill(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()


def _comm_tensor(x: torch.Tensor) -> torch.Tensor:
    return x.to(pdist.comm_device())


def _share_text(text: bytes | None, n: int) -> bytes:
    """Rank 0's text on every rank, broadcast in blocks; raises unless
    every rank's digest equals rank 0's."""
    import numpy as np

    if text is None:
        buf = np.empty(n, np.uint8)
    else:
        buf = np.frombuffer(text, np.uint8)
    for lo in range(0, n, TEXT_BLOCK):
        block = _comm_tensor(torch.from_numpy(
            buf[lo:lo + TEXT_BLOCK].copy()))
        torch.distributed.broadcast(block, 0)
        if text is None:
            buf[lo:lo + TEXT_BLOCK] = block.cpu().numpy()
    if text is None:
        text = buf.tobytes()
    digest = int.from_bytes(hashlib.sha256(text).digest()[:7], "little")
    got = pdist.all_gather_flat(_comm_tensor(
        torch.tensor([digest], dtype=torch.int64)))
    if bool((got != got[0]).any()):
        raise RuntimeError(f"the ranks hold different texts: digests "
                           f"{got.tolist()}")
    return text


def _command(st: State, cmd: int | None = None) -> int:
    """Rank 0 sends ``cmd``; every other rank receives it."""
    t = _comm_tensor(torch.tensor([-1 if cmd is None else cmd]))
    torch.distributed.broadcast(t, 0)
    return int(t.item())


def _build(st: State) -> int:
    """One build on every rank; returns n once every rank has finished."""
    st.last = None
    xs, alpha, n, N = encode_and_shard(st.text, mesh=st.mesh)
    dsa = construct_device(xs, alpha, n, N, st.config, st.mesh)
    tree = construct_suffix_tree_device(dsa, xs)
    del xs
    pdist.barrier("build")
    st.last, st.N = (dsa, tree), N
    return n


def _peaks(st: State) -> list:
    peak = torch.cuda.max_memory_allocated(st.device) \
        if st.device.type == "cuda" else 0
    return pdist.all_gather_flat(_comm_tensor(
        torch.tensor([peak], dtype=torch.int64))).tolist()


def _gather(st: State):
    """The last build's SA, LCP and node table, each rank's block gathered
    to rank 0's host ``GATHER_BLOCK`` elements at a time; rank 0 returns
    the whole padded arrays, the others None."""
    dsa, tree = st.last
    world = pdist.process_count()
    mine = pdist.process_index() == 0
    out = []
    for a in (dsa.sa, dsa.lcp, tree.nodes):
        local = a.shards[0].reshape(-1)
        s = local.shape[0]
        whole = torch.empty(world * s, dtype=local.dtype) if mine else None
        for lo in range(0, s, GATHER_BLOCK):
            block = local[lo:lo + GATHER_BLOCK]
            m = block.shape[0]
            got = pdist.all_gather_flat(_comm_tensor(block))
            if mine:
                got = got.cpu().view(world, m)
                for w in range(world):
                    whole[w * s + lo:w * s + lo + m] = got[w]
        out.append(whole)
    return out if mine else None


def setup(config: dict, traffic: dict, inputs: dict, device,
          rec) -> State:
    device = torch.device(device)
    world = int(traffic["processes"])
    timeout = float(traffic["timeout_s"])
    if device.type == "cuda":
        # one nvcc build here, never several racing ones in the workers
        from psac_tpu_torch.ops import cuda_lib
        cuda_lib.lib()
    port = _free_port()
    cell = {"config": config, "traffic": traffic, "n": len(inputs["text"]),
            "device": device.type, "parent": os.getpid()}
    procs = []
    for r in range(1, world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   **{CELL_VAR: json.dumps(cell)})
        # a worker's standard output goes to standard error: the result
        # line stays the last line of the run's output
        procs.append(subprocess.Popen([sys.executable, __file__], env=env,
                                      stdout=2))
    watch = _Watch(procs)

    def start():
        pdist.init_distributed(traffic["backend"], rank=0, world_size=world,
                               init_method=f"tcp://127.0.0.1:{port}",
                               timeout=timeout)
        text = _share_text(inputs["text"], len(inputs["text"]))
        return State(text=text, config=SAConfig(**config["sa_config"]),
                     device=device, timeout=timeout,
                     mesh=make_mesh(world, [device]), procs=procs,
                     watch=watch)

    st = _guarded(procs, watch, 2 * timeout, start)
    step(st, rec)  # the warm-up build: every shape the window's use
    return st


def _guarded(procs: list, watch: _Watch, seconds: float, fn):
    """``fn()`` within ``seconds``; on an error the workers are killed and
    the process gets 30 s to end."""
    _deadline(seconds)
    try:
        out = fn()
    except BaseException:
        _deadline(30)
        watch.released = True
        kill(procs)
        raise
    _deadline(None)
    return out


def step(st: State, rec) -> dict:
    def run():
        _command(st, BUILD)
        return _build(st)

    return {"count": 1, "bytes": _guarded(st.procs, st.watch, st.timeout,
                                          run)}


def facts(st: State) -> dict:
    def run():
        _command(st, FACTS)
        return _peaks(st)

    peaks = _guarded(st.procs, st.watch, st.timeout, run)
    out = {"n": len(st.text), "N": st.N, "p": st.mesh.p}
    out.update({f"peak_bytes_rank{r}": v for r, v in enumerate(peaks)})
    return out


def outputs(st: State) -> dict:
    """The last build's SA, LCP and node table, real rows only, on rank
    0's host."""
    def run():
        _command(st, GATHER)
        return _gather(st)

    sa, lcp, nodes = _guarded(st.procs, st.watch, st.timeout, run)
    dsa, tree = st.last
    cut = dsa.N - dsa.n
    return {"sa": sa[cut:], "lcp": lcp[cut:],
            "nodes": nodes.view(tree.N, tree.sigma + 1)[cut:]}


def release(st: State) -> None:
    """Stop the workers and leave the group; a worker still there after
    the group's timeout is killed."""
    st.last = None
    _deadline(st.timeout + 30)
    try:
        _command(st, STOP)
        st.watch.released = True
        st.mesh.close()
        pdist.shutdown()
        t0 = time.perf_counter()
        for p in st.procs:
            try:
                p.wait(max(1.0, st.timeout - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                pass
    finally:
        st.watch.released = True
        kill(st.procs)
        _deadline(None)


def _die_with_parent(parent: int) -> None:
    """SIGKILL this process when the process that started it ends."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # noqa
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def worker() -> None:
    """Ranks 1 .. p-1: join, take the text, then run rank 0's commands
    until STOP."""
    cell = json.loads(os.environ[CELL_VAR])
    _die_with_parent(cell["parent"])
    traffic = cell["traffic"]
    timeout = float(traffic["timeout_s"])
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = torch.device("cuda", int(os.environ["LOCAL_RANK"])) \
        if cell["device"] == "cuda" else torch.device("cpu")
    _deadline(2 * timeout)
    pdist.init_distributed(traffic["backend"], timeout=timeout)
    st = State(text=_share_text(None, cell["n"]),
               config=SAConfig(**cell["config"]["sa_config"]),
               device=device, timeout=timeout,
               mesh=make_mesh(world, [device]))
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    while True:
        # a command waits at most for rank 0's set-up (the warm build) or
        # a step, and runs within the group's timeout
        _deadline(2 * timeout)
        cmd = _command(st)
        if cmd == STOP:
            break
        if cmd == BUILD:
            _build(st)
        elif cmd == FACTS:
            _peaks(st)
        elif cmd == GATHER:
            _gather(st)
        else:
            raise RuntimeError(f"rank {rank}: unknown command {cmd}")
    st.last = None
    st.mesh.close()
    pdist.shutdown()
    _deadline(None)


if __name__ == "__main__":
    try:
        worker()
    except BaseException:  # noqa: BLE001 - reported, then a hard exit
        import traceback

        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
