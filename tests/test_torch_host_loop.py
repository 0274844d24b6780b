"""The host-driven construction loop (``SAConfig(fused=False)``) of the
port at ``device="cpu"`` against the JAX package's at p = 1 and against the
native SA-IS + Kasai oracle: the whole padded (isa, sa, lcp) state, the
host-loop iteration count of ``LAST_BUILD``, the ``PSAC_TIMER=1`` section
names in order, and one LCP resolve per dense step with queries plus one
per tail step.  Texts that finish at the k-mer init, that run dense steps
only, and that enter the sparse tail; LCP builds at both tail thresholds,
SA-only builds at factors 2-5, int64 indexes.  Exact equality (integers
only).  The GSA's host loop, ``pack_keys`` and the fused path's hand-over
are in ``tests/test_torch_host_loop_gsa.py``."""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from psac_tpu_torch import SAConfig
from psac_tpu_torch.models import suffix_array as t_sa
from psac_tpu_torch.native import lcp_array, suffix_array
from psac_tpu_torch.ops import rmq as t_rmq
from psac_tpu_torch.ops.alphabet import rand_dna, rep_dna

torch.set_num_threads(1)

#: enters the host loop's tail at tail_threshold_frac 0.1 (403 of 4,096
#: elements active after two doubling steps), two tail steps
REP_TAIL = dict(n=4096, unit_len=128, seed=5, mutations=200)

TEXTS = {
    "dna": rand_dna(3000, seed=1),
    "rep_tail": rep_dna(**REP_TAIL),
    "ab_dna": b"ab" * 500 + rand_dna(64, seed=3),
    "a300": b"a" * 300,
    "mississippi": b"mississippi",
}
CONFIGS = {
    "lcp_tail01": dict(fused=False),
    "lcp_tail0": dict(fused=False, tail_threshold_frac=0.0),
    "f2": dict(fused=False, construct_lcp=False, factor=2),
    "f3": dict(fused=False, construct_lcp=False, factor=3),
    "f4": dict(fused=False, construct_lcp=False, factor=4),
    "f5": dict(fused=False, construct_lcp=False, factor=5),
    "int64": dict(fused=False, force_int64=True),
}


def timer_lines(err: str) -> list[str]:
    """The ``[timer]`` section and info lines of a build, times stripped;
    the summary (ordered by time) left out."""
    out = []
    for line in err.splitlines():
        if not line.startswith("[timer]") or "---- summary" in line or \
                line.startswith("[timer] [construct]   "):
            continue
        out.append(re.sub(r": [0-9.]+ ms$", "", line))
    return out


def _build_jax(t, cfg, mesh1):
    from psac_tpu.config import SAConfig as JaxSAConfig
    from psac_tpu.models import suffix_array as j_sa

    jcfg = JaxSAConfig(**cfg)
    xs, alpha, n, N = j_sa.encode_and_shard(t, mesh1, jcfg)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        jd = j_sa.construct_device(xs, alpha, n, N, mesh1, jcfg)
    return jd, j_sa.LAST_BUILD["host_iters"], timer_lines(err.getvalue())


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("text", sorted(TEXTS))
def test_host_loop_vs_jax_and_native(monkeypatch, mesh1, text, cfg):
    import jax

    monkeypatch.setenv("PSAC_TIMER", "1")
    t, c = TEXTS[text], CONFIGS[cfg]
    jd, j_iters, j_lines = _build_jax(t, c, mesh1)

    calls = []

    def spy(*args, **kw):
        calls.append(kw["nq"])
        return t_rmq.rmq_resolve(*args, **kw)

    monkeypatch.setattr(t_sa, "rmq_resolve", spy)
    xs, alpha, n, N = t_sa.encode_and_shard(t, "cpu")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        td = t_sa.construct_device(xs, alpha, n, N, SAConfig(**c))

    config = SAConfig(**c)
    for name in ("sa", "isa") + (("lcp",) if config.construct_lcp else ()):
        want = np.asarray(jax.device_get(getattr(jd, name)))
        got = getattr(td, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert t_sa.LAST_BUILD["fused"] is False
    assert t_sa.LAST_BUILD["host_iters"] == j_iters
    assert timer_lines(err.getvalue()) == j_lines
    resolves = sum(line.split()[2] in ("lcp-resolve", "tail-step")
                   for line in j_lines) if config.construct_lcp else 0
    assert len(calls) == resolves

    res = td.materialize()
    sa = suffix_array(t)
    np.testing.assert_array_equal(res.sa, sa)
    if config.construct_lcp:
        np.testing.assert_array_equal(res.lcp, lcp_array(t, sa))


def test_texts_reach_the_stages_they_are_named_for(monkeypatch):
    """``rep_tail`` enters the tail at threshold 0.1 and not at 0.0;
    ``mississippi`` and ``dna`` finish at the k-mer init."""
    monkeypatch.setenv("PSAC_TIMER", "1")

    def lines(t, **c):
        xs, alpha, n, N = t_sa.encode_and_shard(t, "cpu")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            t_sa.construct_device(xs, alpha, n, N, SAConfig(**c))
        return timer_lines(err.getvalue())

    tail = lines(TEXTS["rep_tail"], fused=False)
    assert any(x.startswith("[timer] [construct] tail-enter") for x in tail)
    assert sum("tail-step" in x for x in tail) >= 2
    assert sum("doubling-step" in x for x in tail) >= 2
    dense = lines(TEXTS["rep_tail"], fused=False, tail_threshold_frac=0.0)
    assert not any("tail-" in x for x in dense)
    for name in ("mississippi", "dna"):
        lines(TEXTS[name], fused=False)
        assert t_sa.LAST_BUILD["host_iters"] == 0
