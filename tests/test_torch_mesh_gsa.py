"""Generalized suffix array (+GLCP) on a mesh of p > 1 CPU shards against
the JAX package on the conftest's virtual devices at the same p: the whole
padded (N,) sa, lcp, eos and xs (N depends on p) at p = 4 on every set of
tests/test_torch_gsa.py (the duplicates and many-tiny-strings sets of
tests/test_gsa.py among them) and the twin-prefix set that runs both tail
stages, at p = 2 and 8 on some of them; the host-driven loop, SA-only and
int64 at p = 4; the file input with and without a trailing separator and
with empty lines.  Odd p (3, 6, 13: the odd-even block sort) against p = 1
and the native oracle; the tie-fix's capacity retry forced; the entry
points.  The generalized suffix tree on a mesh is in
tests/test_torch_mesh_gst.py.  Exact equality (integers only); each JAX
build compiles its programs for its shapes, seconds apiece, so the cases
are few and small."""

import functools

import numpy as np
import pytest
import torch

from psac_tpu_torch import SAConfig, build_gsa, build_gst
from psac_tpu_torch.models import gsa as t_gsa
from psac_tpu_torch.ops.alphabet import rand_dna
from psac_tpu_torch.parallel.mesh import make_mesh, run_on
from psac_tpu_torch.verify.cases import twin_prefix_set
from psac_tpu_torch.verify.gsa_oracle import gsa_oracle_native
from test_torch_gsa import GST_SETS, SETS

torch.set_num_threads(1)

#: every GSA set of the p = 1 tests, and the twin-prefix set
GSA_SETS = dict(SETS, twin_prefix=twin_prefix_set())
#: flat texts that fill their padded length at p (n == N): SA + depth
#: reaches n, and no position n exists for a start bit
N_EQ_N = {p: [b"abab" * (2 * p), b"ab" * (2 * p), b"ba" * (2 * p)]
          for p in (2, 4, 8)}
#: the sets the JAX builds take, by name
ALL_SETS = dict(GSA_SETS, bananas=GST_SETS["bananas"],
                **{f"n_eq_N{p}": parts for p, parts in N_EQ_N.items()})
CONFIGS = {
    "default": {},
    "host_loop": dict(fused=False),
    "sa_only": dict(construct_lcp=False),
    "int64": dict(force_int64=True),
}
FIELDS = ("sa", "lcp", "eos", "xs")


@functools.lru_cache(maxsize=None)
def cpu_mesh(p: int):
    return make_mesh(p, ["cpu"] * p)


@functools.lru_cache(maxsize=None)
def j_mesh(p: int):
    from psac_tpu.parallel.mesh import make_mesh as j_make_mesh
    return j_make_mesh(p)


def _jax_state(jd) -> dict:
    import jax
    return {f: None if getattr(jd, f) is None
            else np.asarray(jax.device_get(getattr(jd, f))) for f in FIELDS}


@functools.lru_cache(maxsize=None)
def jax_build(p: int, name: str, cfg: str = "default"):
    """The JAX package's ``DeviceGSA`` of a set at p (cached: each JAX
    build compiles its programs for its shapes, seconds on the CPU)."""
    from psac_tpu.config import SAConfig as JaxSAConfig
    from psac_tpu.models.gsa import build_gsa_device

    return build_gsa_device(ALL_SETS[name], mesh=j_mesh(p),
                            config=JaxSAConfig(**CONFIGS[cfg]))


def jax_gsa(p: int, name: str, cfg: str = "default"):
    """The JAX package's padded GSA state, N and lens at p."""
    jd = jax_build(p, name, cfg)
    return _jax_state(jd), jd.N, np.asarray(jd.lens)


def _padded(dg, f):
    x = getattr(dg, f)
    return None if x is None else x.gather().numpy()


def _check_state(dg, want: dict, N: int):
    assert dg.N == N
    for f in FIELDS:
        got = _padded(dg, f)
        if want[f] is None:
            assert got is None, f
            continue
        assert got.dtype == want[f].dtype, f
        np.testing.assert_array_equal(got, want[f], err_msg=f)


#: every set at p = 4; at p = 2 and 8 the tie-fix's (duplicates), the
#: many tiny strings' and both tail stages' (twin_prefix)
STATE_CASES = [(4, name) for name in sorted(GSA_SETS)] + [
    (2, "duplicates"), (2, "twin_prefix"), (8, "tiny"), (8, "twin_prefix")]


@pytest.mark.parametrize("p,name", STATE_CASES)
def test_padded_state_vs_jax(p, name):
    want, N, lens = jax_gsa(p, name)
    dg = t_gsa.build_gsa_device(GSA_SETS[name], mesh=cpu_mesh(p))
    assert dg.mesh is cpu_mesh(p) and dg.sa.p == p
    np.testing.assert_array_equal(dg.lens, lens)
    _check_state(dg, want, N)


@pytest.mark.parametrize("cfg,name", [("host_loop", "twin_prefix"),
                                      ("sa_only", "mixed"),
                                      ("int64", "mixed")])
def test_configs_vs_jax(cfg, name):
    """``fused=False`` (dense steps with the routed resolve, then the
    one-stage tail), ``construct_lcp=False`` and ``force_int64`` at p = 4
    (``mixed`` runs dense steps and the tail)."""
    want, N, _ = jax_gsa(4, name, cfg)
    dg = t_gsa.build_gsa_device(GSA_SETS[name], mesh=cpu_mesh(4),
                                config=SAConfig(**CONFIGS[cfg]))
    _check_state(dg, want, N)


@pytest.mark.parametrize("p,name", [
    (3, "duplicates"), (3, "mixed"), (3, "near_identical"),
    (6, "duplicates"), (6, "mixed"), (13, "duplicates"), (13, "tiny")])
def test_odd_mesh_vs_p1_and_oracle(p, name):
    """Odd p takes the odd-even block sort: the real rows equal the p = 1
    build's and the native oracle's."""
    strings = GSA_SETS[name]
    got = build_gsa(strings, mesh=cpu_mesh(p))
    want_sa, want_lcp = gsa_oracle_native(*t_gsa._flatten(strings))
    one = build_gsa(strings, "cpu")
    for res in (got, one):
        np.testing.assert_array_equal(res.sa, want_sa)
        np.testing.assert_array_equal(res.lcp, want_lcp)
    np.testing.assert_array_equal(got.lens, one.lens)


def test_twin_prefix_at_p3_host_loop():
    """Both tail stages at p = 3 on the fused path, the one-stage tail and
    the routed resolve on the host-driven loop."""
    strings = GSA_SETS["twin_prefix"]
    want_sa, want_lcp = gsa_oracle_native(*t_gsa._flatten(strings))
    for cfg in (SAConfig(), SAConfig(fused=False)):
        res = build_gsa(strings, mesh=cpu_mesh(3), config=cfg)
        np.testing.assert_array_equal(res.sa, want_sa)
        np.testing.assert_array_equal(res.lcp, want_lcp)


GSA_FILE_PARTS = [rand_dna(int(ln), seed=70 + i) for i, ln in
                  enumerate(np.random.RandomState(31).randint(1, 90, 25))]
GSA_FILES = {
    "trailing_separator": b"\n".join(GSA_FILE_PARTS) + b"\n",
    "no_trailing_separator": b"\n".join(GSA_FILE_PARTS),
    "empty_lines": b"\n\n" + b"\n\n".join(GSA_FILE_PARTS[:9]),
}


@pytest.mark.parametrize("p,name", [
    (4, "trailing_separator"), (4, "no_trailing_separator"),
    (2, "empty_lines"), (8, "trailing_separator")])
def test_from_file_vs_jax(tmp_path, p, name):
    """The file input's per-shard separator drop (JAX ``_gsac_stage_fn``):
    the padded state and lens equal the JAX package's
    ``build_gsa_from_file`` and the port's in-memory build at p."""
    from psac_tpu.models.gsa import build_gsa_from_file as j_from_file

    content = GSA_FILES[name]
    f = tmp_path / "strings.txt"
    f.write_bytes(content)
    jd = j_from_file(str(f), mesh=j_mesh(p))
    dg = t_gsa.build_gsa_from_file(str(f), mesh=cpu_mesh(p))
    np.testing.assert_array_equal(dg.lens, np.asarray(jd.lens))
    _check_state(dg, _jax_state(jd), jd.N)
    mem = t_gsa.build_gsa_device(content, mesh=cpu_mesh(p))
    for fld in FIELDS:
        np.testing.assert_array_equal(_padded(dg, fld), _padded(mem, fld))


def test_drop_separators_at_every_p():
    """The separator drop alone: the flat bytes and the separators' file
    positions equal a host split at p = 1, 2, 3, 4 and 8."""
    content = GSA_FILES["empty_lines"] + b"\nACGT\n"
    buf = np.frombuffer(content, np.uint8)
    seps = np.flatnonzero(buf == 0x0A)
    flat = buf[buf != 0x0A]
    for p in (1, 2, 3, 4, 8):
        N_file = 8 * p * (-(-len(buf) // (8 * p)))
        N_flat = 8 * p * (-(-len(flat) // (8 * p)))
        fb = torch.zeros(N_file, dtype=torch.uint8)
        fb[:len(buf)] = torch.from_numpy(buf.copy())
        mesh = cpu_mesh(p) if p > 1 else None
        xb, sep_pos = run_on(mesh, t_gsa._drop_separators,
                             mesh.shard(fb) if mesh else fb, len(buf),
                             N_flat // p, len(seps), 0x0A, torch.int32)
        got = (xb.gather() if mesh else xb).numpy()
        np.testing.assert_array_equal(got[:len(flat)], flat)
        assert not got[len(flat):].any()
        np.testing.assert_array_equal(sep_pos.numpy(), seps)


def _tiny_caps(monkeypatch, module, calls):
    """``module.cap_for`` giving a routing capacity of 2 at a capscale."""
    real = module.cap_for

    def tiny(m, p, capscale):
        calls.append(capscale)
        return 2 if capscale is not None else real(m, p, capscale)

    monkeypatch.setattr(module, "cap_for", tiny)


@pytest.mark.parametrize("cfg", ["default", "host_loop"])
def test_tiefix_retries_on_overflow(monkeypatch, cfg):
    """The tie-fix at capscale 6 forced to overflow (a routing capacity of
    2): its dropped rows keep the sentinel, the pass at full capacity
    finds them, and the state equals the one that never overflows and the
    JAX package's."""
    strings = GSA_SETS["duplicates"]
    config = SAConfig(**CONFIGS[cfg])
    want = t_gsa.build_gsa_device(strings, mesh=cpu_mesh(4), config=config)
    calls = []
    _tiny_caps(monkeypatch, t_gsa, calls)
    got = t_gsa.build_gsa_device(strings, mesh=cpu_mesh(4), config=config)
    assert calls.count(6) == 4 and calls.count(None) == 4
    for f in FIELDS:
        np.testing.assert_array_equal(_padded(got, f), _padded(want, f))
    jwant, N, _ = jax_gsa(4, "duplicates")
    _check_state(got, jwant, N)


def test_entry_points_on_a_mesh():
    """``build_gsa`` and ``build_gst`` at p = 2 equal their p = 1 results;
    a mesh of one shard is its device."""
    strings = [b"ab", b"ba", b"banana", b"ananas"]
    for mesh in (cpu_mesh(2), make_mesh(1, ["cpu"])):
        a, b = build_gsa(strings, mesh=mesh), build_gsa(strings, "cpu")
        np.testing.assert_array_equal(a.sa, b.sa)
        np.testing.assert_array_equal(a.lcp, b.lcp)
        np.testing.assert_array_equal(build_gst(strings, mesh=mesh),
                                      build_gst(strings, "cpu"))
    one = t_gsa.build_gsa_device(strings, mesh=make_mesh(1, ["cpu"]))
    assert one.mesh is None and one.sa.device.type == "cpu"


@pytest.mark.parametrize("p,name", [(3, "empty_lines"),
                                    (4, "trailing_separator"),
                                    (5, "no_trailing_separator")])
def test_buffer_split_on_the_shards_as_the_list_form(p, name):
    """A newline-separated buffer is staged raw over the shards and split
    there: its padded state equals the list form's at the same p."""
    content = GSA_FILES[name]
    parts = [x for x in content.split(b"\n") if x]
    buf = t_gsa.build_gsa_device(content, mesh=cpu_mesh(p))
    lst = t_gsa.build_gsa_device(parts, mesh=cpu_mesh(p))
    np.testing.assert_array_equal(buf.lens, lst.lens)
    assert (buf.n, buf.N) == (lst.n, lst.N)
    for fld in FIELDS:
        np.testing.assert_array_equal(_padded(buf, fld), _padded(lst, fld))
