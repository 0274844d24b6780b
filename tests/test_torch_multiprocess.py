"""The mesh across processes: 2 worker processes over ``torch.distributed``
(gloo, on the CPU) x 2 CPU shards each = one global mesh of P = 4 shards,
and 2 x 1 (P = 2), mirroring ``tests/test_multiprocess.py``.

Each worker imports torch only (never JAX), stages its inputs per process,
builds on the global mesh and writes what it found to files; the test
holds those against the JAX package at the same P (the conftest's virtual
devices), against the port's thread mesh at the same P, or against the
oracles of the JAX test.  Exact comparison throughout.  The mesh's
refusals (a gather or a host result of an array that spans processes, the
public ANSV, a P that the process count does not divide, NCCL without a
card per process) and a peer that raises, dies or hangs are covered too.
Every wait on a worker has a time limit and kills all workers when it runs
out, so a hang fails the test instead of the suite.
"""

import os
import re
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from psac_tpu_torch import io as t_io
from psac_tpu_torch.models import desa as t_desa
from psac_tpu_torch.models import suffix_array as t_sa
from psac_tpu_torch.ops.alphabet import Alphabet, rand_dna
from psac_tpu_torch.parallel import dist as t_dist
from psac_tpu_torch.parallel.mesh import Sharded, make_mesh
from psac_tpu_torch.verify.gsa_oracle import gsa_oracle
from psac_tpu_torch.verify.suffix_tree_oracle import gst_oracle

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a worker may take, start-up included
WAIT_S = 150

#: the shard function of the collectives case, run by the workers and by a
#: thread mesh here
COLLECTIVES = r"""
import torch
from psac_tpu_torch.parallel.mesh import Rep

def collectives(ctx, x):
    p, r = ctx.p, ctx.rank
    ag = ctx.all_gather((x, x > 3, x.sum().to(torch.int32)))
    shift = ctx.ppermute((x, x.to(torch.int32)),
                         [(i + 1, i) for i in range(p - 1)])
    flip = ctx.ppermute(x.flip(0), [(i, p - 1 - i) for i in range(p)])
    one = ctx.ppermute(x[:3], [(0, p - 1)])
    swap = ctx.ppermute(x, [(a, a ^ 1) for a in range(p)])
    buf = torch.stack([x[:4] * (j + 1) + r for j in range(p)])
    a2a = ctx.all_to_all((buf, buf % 3 == 0, buf.to(torch.int32)[:, :0]))
    return (ag[0].reshape(-1), ag[1].reshape(-1), ag[2], shift[0], shift[1],
            flip, one, swap, a2a[0].reshape(-1), a2a[1].reshape(-1),
            a2a[2].reshape(-1), Rep(ctx.psum(x.sum())),
            Rep(ctx.pmax(x.max())))
"""

_WORKER = r"""
import dataclasses, os, sys, time
rank, world, port, case, work, L = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5],
                                    int(sys.argv[6]))
import numpy as np
import torch
torch.set_num_threads(1)
from psac_tpu_torch.parallel import dist as pdist
from psac_tpu_torch.parallel.mesh import Sharded, make_mesh

pdist.init_distributed("gloo", rank=rank, world_size=world,
                       init_method=f"tcp://127.0.0.1:{port}",
                       timeout=float(os.environ.get("PSAC_TEST_TIMEOUT", 60)))
assert (pdist.process_index(), pdist.process_count()) == (rank, world)
P = world * L
mesh = make_mesh(P, [os.environ.get("PSAC_TEST_DEVICE", "cpu")] * L)
assert (mesh.p, mesh.local, mesh.first) == (P, L, rank * L)
found = {}


def refuses(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


if case == "collectives":
    exec(open(os.path.join(work, "collectives.py")).read())
    x = torch.arange(8 * P, dtype=torch.int64) * 7 % 19
    outs = mesh.run(collectives, mesh.shard(x))
    found["outs"] = [pdist.process_allgather(o) if isinstance(o, Sharded)
                     else o for o in outs]
    found["local"] = len(outs[0].shards)

if case == "sa":
    from psac_tpu_torch import io as io_mod
    from psac_tpu_torch.models.suffix_array import construct_from_file
    from psac_tpu_torch.parallel.ansv import ansv
    from psac_tpu_torch.verify.check_sa import d_check_sa
    from psac_tpu_torch.ops.ansv import NEAREST_SM

    dsa, xs = construct_from_file(os.path.join(work, "corpus.bin"),
                                  mesh=mesh)
    found["ok"] = d_check_sa(dsa, xs)
    shards = [t.clone() for t in dsa.sa.shards]
    if dsa.sa.first + L == P:  # the last shard: swap two of its rows
        shards[-1][-1], shards[-1][-7] = (shards[-1][-7].clone(),
                                          shards[-1][-1].clone())
    found["swapped"] = d_check_sa(dataclasses.replace(
        dsa, sa=Sharded(shards, dsa.sa.first, P)), xs)
    found["n"], found["N"] = dsa.n, dsa.N
    found["sa"] = pdist.process_allgather(dsa.sa)
    found["lcp"] = pdist.process_allgather(dsa.lcp)
    pre = os.path.join(work, "art")
    io_mod.write_suffix_array_distributed(pre, dsa)
    pdist.barrier("after-write")
    back = io_mod.read_suffix_array_distributed(pre, mesh)
    found["back"] = (back.n, back.N, pdist.process_allgather(back.sa),
                     pdist.process_allgather(back.lcp))
    found["refusals"] = dict(
        gather=refuses(dsa.sa.gather), materialize=refuses(dsa.materialize),
        ansv=refuses(lambda: ansv(np.arange(10), NEAREST_SM, NEAREST_SM,
                                  mesh=mesh)),
        odd_p=refuses(lambda: make_mesh(P + 1, ["cpu"] * L)))

if case == "gsa":
    from psac_tpu_torch.models.gsa import build_gsa_from_file
    from psac_tpu_torch.models.suffix_tree import construct_gst_device

    dg = build_gsa_from_file(os.path.join(work, "strings.txt"), mesh=mesh)
    tree = construct_gst_device(dg)
    off = dg.N - dg.n
    found["sa"] = pdist.process_allgather(dg.sa)[off:]
    found["lcp"] = pdist.process_allgather(dg.lcp)[off:]
    found["nodes"] = pdist.process_allgather(tree.nodes).view(
        tree.N, tree.sigma + 1)[off:]
    found["lens"] = dg.lens

if case == "desa":
    from psac_tpu_torch.models import desa as desa_mod

    corpus = os.path.join(work, "corpus.bin")
    text = open(corpus, "rb").read()
    pats = [bytes(p) for p in np.load(os.path.join(work, "pats.npy"),
                                      allow_pickle=True)]
    idx = desa_mod.build_desa(text, mesh=mesh)
    found["ranges"] = idx.bulk_locate(pats)
    idx2 = desa_mod.build_desa_from_file(corpus, mesh=mesh)
    found["file"] = idx2.bulk_locate(pats)
    pre = os.path.join(work, "desa_art")
    desa_mod.write_desa_distributed(idx2, pre)
    pdist.barrier("after-desa-write")
    idx3 = desa_mod.read_desa_from_file(corpus, pre, mesh=mesh)
    found["reload"] = idx3.bulk_locate(pats)
    tldt = desa_mod.build_desa_from_file(corpus, mesh=mesh, tli="tldt")
    found["tldt"] = tldt.bulk_locate(pats)
    found["samples"] = tldt.samp["m"]
    found["refusals"] = dict(
        arrays=refuses(lambda: desa_mod.desa_arrays(idx2)),
        write=refuses(lambda: desa_mod.write_desa(idx2, pre + "x")))

if case == "build":
    from psac_tpu_torch.models.suffix_array import construct_from_file
    from psac_tpu_torch.models.suffix_tree import construct_suffix_tree_device
    from psac_tpu_torch.ops import bansv, rmq

    before = (rmq.rmq_mins.launches, bansv.block_psv.launches)
    dsa, xs = construct_from_file(os.path.join(work, "corpus.bin"),
                                  mesh=mesh)
    tree = construct_suffix_tree_device(dsa, xs)
    found["launches"] = (rmq.rmq_mins.launches - before[0],
                         bansv.block_psv.launches - before[1])
    found["devices"] = sorted({str(t.device) for t in dsa.sa.shards})
    found["arrays"] = [pdist.process_allgather(a)
                       for a in (dsa.isa, dsa.sa, dsa.lcp, tree.nodes)]

if case.startswith("fail_"):
    def body(ctx, x):
        if ctx.rank == P - 1:
            if case == "fail_raise":
                raise ValueError("shard fails on purpose")
            if case == "fail_exit":
                os._exit(3)
            time.sleep(float(os.environ["PSAC_TEST_TIMEOUT"]) + 6)
        return ctx.all_gather(x)

    t0 = time.perf_counter()
    try:
        mesh.run(body, mesh.shard(torch.arange(8 * P)))
    finally:
        print(f"rank {rank}: failed after {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"rank {rank}: did not fail", flush=True)

torch.save(found, os.path.join(work, f"{case}.{rank}.pt"))
pdist.barrier("end")
pdist.shutdown()
print(f"rank {rank}: {case} OK", flush=True)
"""


def _free_port() -> int:
    """A port free now, never one of the fixed ports of
    ``tests/test_multiprocess.py``, which may run at the same time."""
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port not in (39247, 39251):
            return port


def run_workers(work, case: str, world: int = 2, local: int = 2,
                timeout_s: float = 60, expect_ok: bool = True,
                device: str = "cpu") -> list:
    """Start ``world`` workers on ``case``, each with ``local`` shards on
    ``device``, and wait for all of them (at most ``WAIT_S``; all are
    killed when that runs out).  Returns each one's (return code, output,
    seconds)."""
    script = os.path.join(work, "worker.py")
    with open(script, "w") as f:
        f.write(_WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               PSAC_TEST_TIMEOUT=str(timeout_s), PSAC_TEST_DEVICE=device)
    port = str(_free_port())
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), str(world), port, case, str(work),
         str(local)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            left = max(1.0, WAIT_S - (time.perf_counter() - t0))
            out = p.communicate(timeout=left)[0].decode()
            outs.append((p.returncode, out, time.perf_counter() - t0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if expect_ok:
        for r, (rc, out, _) in enumerate(outs):
            assert rc == 0, f"worker {r} failed:\n{out[-4000:]}"
            assert f"rank {r}: {case} OK" in out
    return outs


def found(work, case: str, world: int = 2) -> list:
    return [torch.load(os.path.join(work, f"{case}.{r}.pt"),
                       weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,local", [(2, 2), (2, 1)])
def test_collectives_equal_the_thread_mesh(tmp_path, world, local):
    """Every collective of ``Ctx`` (a tuple of int64, bool and 0-d
    tensors, shifts with zero fill, a flip, one pair, swaps, an all-to-all
    with an empty column, psum, pmax) gives on 2 processes what it gives
    on a thread mesh of the same P."""
    (tmp_path / "collectives.py").write_text(COLLECTIVES)
    run_workers(tmp_path, "collectives", world, local)
    P = world * local
    scope = {}
    exec(COLLECTIVES, scope)
    x = torch.arange(8 * P, dtype=torch.int64) * 7 % 19
    mesh = make_mesh(P, ["cpu"] * P)
    want = mesh.run(scope["collectives"], mesh.shard(x))
    mesh.close()
    want = [w.gather() if isinstance(w, Sharded) else w for w in want]
    for got in found(tmp_path, "collectives", world):
        assert got["local"] == local
        assert len(got["outs"]) == len(want)
        for g, w in zip(got["outs"], want):
            assert g.dtype == w.dtype and torch.equal(g, w)


# ---------------------------------------------------------------------------
# SA + LCP from a file, d_check_sa, the per-shard files and the reload
# ---------------------------------------------------------------------------

def _jax_sa(path: str, p: int, prefix: str):
    """The JAX package's padded SA/LCP of a file at p, its distributed
    files at ``prefix`` and their distributed reload."""
    from psac_tpu import io as j_io
    from psac_tpu.models import suffix_array as j_sa
    from psac_tpu.parallel.mesh import make_mesh as j_make_mesh

    mesh = j_make_mesh(p)
    dsa, _ = j_sa.construct_from_file(path, mesh=mesh)
    j_io.write_suffix_array_distributed(prefix, dsa)
    back = j_io.read_suffix_array_distributed(prefix, mesh)
    return dsa, back


@pytest.mark.parametrize("world,local", [(2, 2), (2, 1)])
def test_sa_from_file_equals_jax(tmp_path, world, local):
    """SA + LCP of a file staged per process: ``d_check_sa`` true (false
    with two rows swapped), the padded SA/LCP equal to JAX's
    ``construct_from_file`` at the same P, the files of
    ``write_suffix_array_distributed`` byte-equal to JAX's, and the
    distributed reload equal to JAX's; the refusals."""
    rng = np.random.RandomState(42)
    text = bytes(rng.randint(97, 101, 20000).astype(np.uint8))
    (tmp_path / "corpus.bin").write_bytes(text)
    run_workers(tmp_path, "sa", world, local)
    P = world * local
    jdsa, jback = _jax_sa(str(tmp_path / "corpus.bin"), P,
                          str(tmp_path / "jax_art"))
    for got in found(tmp_path, "sa", world):
        assert got["ok"] is True and got["swapped"] is False
        assert (got["n"], got["N"]) == (jdsa.n, jdsa.N)
        np.testing.assert_array_equal(got["sa"].numpy(), np.asarray(jdsa.sa))
        np.testing.assert_array_equal(got["lcp"].numpy(),
                                      np.asarray(jdsa.lcp))
        n, N, bsa, blcp = got["back"]
        assert (n, N) == (jback.n, jback.N)
        np.testing.assert_array_equal(bsa.numpy(), np.asarray(jback.sa))
        np.testing.assert_array_equal(blcp.numpy(), np.asarray(jback.lcp))
        assert got["refusals"] == dict(gather=True, materialize=True,
                                       ansv=True, odd_p=True)
    for ext in (".sa64", ".lcp64", ".alpha"):
        assert (tmp_path / f"art{ext}").read_bytes() == \
            (tmp_path / f"jax_art{ext}").read_bytes(), ext


# ---------------------------------------------------------------------------
# GSA + GLCP and the GST of a string-set file
# ---------------------------------------------------------------------------

def test_gsa_gst_from_file_equal_the_oracles(tmp_path):
    """The JAX test's string set (40 strings of 1-79 characters over six
    letters) as a file: GSA, GLCP and the GST node table built on 2
    processes x 2 shards equal the sorting oracle and ``gst_oracle``."""
    rng = np.random.RandomState(7)
    rng.randint(97, 101, 8000)  # the JAX test draws its text first
    parts = [bytes(rng.randint(97, 103, rng.randint(1, 80)).astype(np.uint8))
             for _ in range(40)]
    (tmp_path / "strings.txt").write_bytes(b"\n".join(parts) + b"\n")
    run_workers(tmp_path, "gsa")
    sa, lcp = gsa_oracle(parts)
    flat = b"".join(parts)
    lens = np.array([len(x) for x in parts], np.int64)
    eos = np.repeat(np.cumsum(lens), lens)
    alpha = Alphabet.from_bytes(flat)
    nodes = gst_oracle(alpha.encode(flat), sa, lcp, eos, alpha.sigma)
    for got in found(tmp_path, "gsa"):
        np.testing.assert_array_equal(got["lens"], lens)
        np.testing.assert_array_equal(got["sa"].numpy(), sa)
        glcp = got["lcp"].numpy().astype(np.int64)
        glcp[0] = 0
        np.testing.assert_array_equal(glcp, lcp)
        np.testing.assert_array_equal(got["nodes"].numpy(), nodes)


# ---------------------------------------------------------------------------
# the DESA: build, query, per-shard files, reload
# ---------------------------------------------------------------------------

def test_desa_across_processes(tmp_path):
    """The JAX test's text and patterns (and more: absent, out of the
    alphabet, across shard edges): ``bulk_locate`` of ``build_desa`` and
    of ``build_desa_from_file`` on 2 processes x 2 shards equal the port's
    one-device ranges and the naive occurrence counts; the files of
    ``write_desa_distributed`` are byte-equal to ``write_desa``'s on one
    device; ``read_desa_from_file`` of them and the TLDT answer alike;
    ``desa_arrays`` and ``write_desa`` refuse."""
    rng = np.random.RandomState(7)
    text = bytes(rng.randint(97, 101, 8000).astype(np.uint8))
    (tmp_path / "corpus.bin").write_bytes(text)
    pats = [text[0:8], text[100:110], text[777:781], b"zzzz",
            text[5000:5032], b"", text[1995:2006], text[3999:4003],
            text[7990:8000], b"ab", b"abcdabcdabcd"]
    np.save(tmp_path / "pats.npy", np.array(pats, dtype=object),
            allow_pickle=True)
    run_workers(tmp_path, "desa")
    one = t_desa.build_desa(text, device="cpu")
    want = one.bulk_locate(pats)
    t_desa.write_desa(one, str(tmp_path / "one"))
    for pat, (lo, hi) in zip(pats, want):
        occ = sum(1 for i in range(len(text) - len(pat) + 1)
                  if text[i:i + len(pat)] == pat) if pat else 0
        assert hi - lo == occ, pat
    for got in found(tmp_path, "desa"):
        for key in ("ranges", "file", "reload", "tldt"):
            np.testing.assert_array_equal(got[key], want, err_msg=key)
        assert got["samples"] >= 2
        assert got["refusals"] == dict(arrays=True, write=True)
    for ext in (".sa64", ".lcp64", ".lc64", ".alpha"):
        assert (tmp_path / f"desa_art{ext}").read_bytes() == \
            (tmp_path / f"one{ext}").read_bytes(), ext


# ---------------------------------------------------------------------------
# failures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["raise", "exit", "hang"])
def test_a_failing_peer_fails_the_others(tmp_path, how):
    """A shard that raises (its process leaves the group and ends), whose
    process dies, or that hangs: the other process fails at its collective
    too, within the group's timeout, and no worker reports success."""
    timeout_s = 10
    outs = run_workers(tmp_path, f"fail_{how}", 2, 1, timeout_s=timeout_s,
                       expect_ok=False)
    for r, (rc, out, secs) in enumerate(outs):
        assert rc != 0, f"worker {r} did not fail:\n{out[-3000:]}"
        assert "did not fail" not in out
    if how == "raise":
        assert "shard fails on purpose" in outs[1][1]
    # the surviving process fails at the peer's exit or at its timeout
    m = re.search(r"rank 0: failed after ([0-9.]+) s", outs[0][1])
    assert m and float(m.group(1)) < timeout_s + 5, outs[0][1][-3000:]


def test_nccl_needs_a_card_per_process(monkeypatch):
    """NCCL without a card for each process on the host raises before any
    group exists; so do an unknown backend and missing torchrun
    variables.  No backend is chosen for the caller."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="one CUDA card per process"):
        t_dist.init_distributed("nccl", rank=0, world_size=2,
                                init_method="tcp://127.0.0.1:1")
    with pytest.raises(ValueError, match="gloo"):
        t_dist.init_distributed("mpi", rank=0, world_size=2,
                                init_method="tcp://127.0.0.1:1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="RANK, WORLD_SIZE, MASTER_ADDR"):
        t_dist.init_distributed("gloo")
    assert not torch.distributed.is_initialized()
    assert (t_dist.process_count(), t_dist.process_index()) == (1, 0)


# ---------------------------------------------------------------------------
# the per-shard IO on one process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A 3,001-character file built by JAX at p = 4 and p = 1 and by the
    port on a thread mesh of 4 and on one device; their distributed files
    under one directory."""
    from psac_tpu import io as j_io
    from psac_tpu.models import suffix_array as j_sa
    from psac_tpu.parallel.mesh import make_mesh as j_make_mesh

    d = tmp_path_factory.mktemp("io")
    path = str(d / "text.bin")
    with open(path, "wb") as f:
        f.write(rand_dna(3001, seed=3))
    out = {"dir": d, "path": path}
    for p in (4, 1):
        jmesh = j_make_mesh(p)
        jd, _ = j_sa.construct_from_file(path, mesh=jmesh)
        j_io.write_suffix_array_distributed(str(d / f"jax{p}"), jd)
        out[("jax", p)] = (jd, jmesh)
        mesh = make_mesh(4, ["cpu"] * 4) if p == 4 else None
        td, _ = t_sa.construct_from_file(path, "cpu", mesh=mesh)
        out[("port", p)] = (td, mesh)
    return out


@pytest.mark.parametrize("p", [4, 1])
def test_write_suffix_array_distributed_on_one_process(built, p):
    """On a thread mesh of 4 and on one device: the files equal JAX's
    distributed files and ``write_suffix_array`` of the host result."""
    d = built["dir"]
    td, _ = built[("port", p)]
    t_io.write_suffix_array_distributed(str(d / f"port{p}"), td)
    t_io.write_suffix_array(str(d / f"host{p}"), td.materialize())
    for ext in (".sa64", ".lcp64", ".alpha"):
        got = (d / f"port{p}{ext}").read_bytes()
        assert got == (d / f"jax{p}{ext}").read_bytes(), ext
        assert got == (d / f"host{p}{ext}").read_bytes(), ext


@pytest.mark.parametrize("front_pad,fix", [(True, False), (True, True),
                                           (False, False)])
@pytest.mark.parametrize("p", [4, 1])
def test_write_shards_u64_equals_jax(built, p, front_pad, fix):
    """``write_shards_u64`` of the padded LCP with and without the front
    padding and the first-row fix: the bytes of the JAX function."""
    from psac_tpu import io as j_io

    d = built["dir"]
    td, _ = built[("port", p)]
    jd, _ = built[("jax", p)]
    n = td.n if front_pad else td.N
    tag = f"{p}{int(front_pad)}{int(fix)}"
    t_io.write_shards_u64(str(d / f"w{tag}.t"), td.lcp, n,
                          front_pad=front_pad, fix_first_zero=fix)
    j_io.write_shards_u64(str(d / f"w{tag}.j"), jd.lcp, n,
                          front_pad=front_pad, fix_first_zero=fix)
    assert (d / f"w{tag}.t").read_bytes() == (d / f"w{tag}.j").read_bytes()


@pytest.mark.parametrize("p", [4, 1])
def test_stage_and_read_distributed_equal_jax(built, p):
    """``stage_u64_front_padded`` and ``read_suffix_array_distributed`` of
    JAX's files: the arrays of the JAX functions on the same p (int32,
    and int64 when forced)."""
    from psac_tpu import io as j_io

    d = built["dir"]
    _, mesh = built[("port", p)]
    _, jmesh = built[("jax", p)]
    where = mesh if mesh is not None else "cpu"
    pre = str(d / f"jax{p}")
    arr, n, N = t_io.stage_u64_front_padded(pre + ".sa64", where,
                                            torch.int64)
    jarr, jn, jN = j_io.stage_u64_front_padded(pre + ".sa64", jmesh)
    assert (n, N) == (jn, jN)
    got = arr.gather() if mesh is not None else arr
    np.testing.assert_array_equal(got.numpy(), np.asarray(jarr))
    for force in (False, True):
        back = t_io.read_suffix_array_distributed(pre, where, force)
        jback = j_io.read_suffix_array_distributed(pre, jmesh, force)
        assert (back.n, back.N) == (jback.n, jback.N)
        assert back.mesh is mesh
        for f in ("sa", "lcp"):
            t = getattr(back, f)
            t = t.gather() if mesh is not None else t
            j = np.asarray(getattr(jback, f))
            # the JAX arrays stay int32 where x64 is off; the values agree
            assert t.dtype == (torch.int64 if force else torch.int32)
            np.testing.assert_array_equal(t.numpy(), j)
        assert back.alphabet.chars.tobytes() == jback.alphabet.chars.tobytes()
