"""The port's command-line tools and artifact IO against the JAX package's
(``tests/test_cli_io.py`` case by case with ``--device cpu``): the files
both packages write for one input are byte-identical, and each package
loads what the other wrote; with ``--devices P`` (P shards on the CPU)
against the JAX CLI at the same ``--devices``.  Also the from-file entry points
(``construct_from_file``, ``build_gsa_from_file``, the DESA's) against the
JAX package's at p = 1.  Exact equality (integers and bytes only)."""

import types

import numpy as np
import pytest
import torch

from psac_tpu_torch.ops.alphabet import rand_dna, rep_dna

torch.set_num_threads(1)


def run_cli(argv):
    from psac_tpu_torch.cli import main
    return main(argv + ["--device", "cpu"]) if argv[0] != "print64" \
        else main(argv)


def run_jax_cli(argv, devices: int = 1):
    from psac_tpu.cli import main
    return main(argv + (["--devices", str(devices)] if argv[0] != "print64"
                        else []))


def _same_files(a: str, b: str, exts) -> None:
    for ext in exts:
        with open(a + ext, "rb") as fa, open(b + ext, "rb") as fb:
            assert fa.read() == fb.read(), ext


# ---------------------------------------------------------------------------
# the cases of tests/test_cli_io.py
# ---------------------------------------------------------------------------

def test_psac_check_write_read(tmp_path, mesh1):
    text = rand_dna(2000, seed=4)
    f = tmp_path / "in.txt"
    f.write_bytes(text)
    pre = str(tmp_path / "out")
    assert run_cli(["psac", "-f", str(f), "-l", "-c", "-o", pre]) == 0

    from psac_tpu.models.suffix_array import build_suffix_array

    from psac_tpu_torch.io import read_suffix_array
    res = read_suffix_array(pre)
    res1 = build_suffix_array(text, mesh=mesh1)
    np.testing.assert_array_equal(res.sa, res1.sa)
    np.testing.assert_array_equal(res.lcp, res1.lcp)
    assert res.alphabet.sigma == 4


def test_print64_mkpattern(tmp_path, capsys):
    text = rand_dna(500, seed=1)
    f = tmp_path / "t.txt"
    f.write_bytes(text)
    pat = tmp_path / "p.txt"
    assert run_cli(["mkpattern", "-f", str(f), "-n", "5", "-l", "8",
                    "-o", str(pat)]) == 0
    lines = pat.read_bytes().strip().split(b"\n")
    assert len(lines) == 5 and all(len(x) == 8 for x in lines)
    assert all(x in text for x in lines)
    jpat = tmp_path / "jp.txt"
    assert run_jax_cli(["mkpattern", "-f", str(f), "-n", "5", "-l", "8",
                        "-o", str(jpat)]) == 0
    assert jpat.read_bytes() == pat.read_bytes()

    from psac_tpu_torch.io import write_u64
    write_u64(str(tmp_path / "v.u64"), np.array([3, 1, 2**40]))
    assert run_cli(["print64", str(tmp_path / "v.u64")]) == 0
    out = capsys.readouterr().out.strip().split("\n")
    assert out == ["3", "1", str(2**40)]


def test_gsac_cli(tmp_path):
    f = tmp_path / "ss.txt"
    f.write_bytes(b"banana\nana\nnab\nbanana\n")
    assert run_cli(["gsac", "-f", str(f), "-c"]) == 0


def test_desa_cli_save_load_query(tmp_path):
    from psac_tpu_torch.models.desa import build_desa, read_desa

    text = rand_dna(3000, seed=8)
    f = tmp_path / "t.txt"
    f.write_bytes(text)
    pat = tmp_path / "p.txt"
    run_cli(["mkpattern", "-f", str(f), "-n", "16", "-l", "12", "-o",
             str(pat)])
    pre = str(tmp_path / "idx")
    assert run_cli(["desa", "-f", str(f), "-o", pre, "-q", str(pat),
                    "--reps", "1"]) == 0
    patterns = [x for x in pat.read_bytes().split(b"\n") if x]
    fresh = build_desa(text, "cpu").bulk_locate(patterns)
    loaded = read_desa(text, pre, "cpu").bulk_locate(patterns)
    np.testing.assert_array_equal(fresh, loaded)
    assert run_cli(["desa", "-f", str(f), "--load", pre, "--tli", "tldt",
                    "-q", str(pat), "--reps", "1"]) == 0


def test_kmer_stats_and_dss(tmp_path, capsys):
    text = rand_dna(4000, seed=2)
    f = tmp_path / "t.txt"
    f.write_bytes(text)
    assert run_cli(["kmer-stats", "-f", str(f), "-t", "8", "-p", "4"]) == 0
    got = capsys.readouterr().out
    assert "imbalance=" in got
    assert run_jax_cli(["kmer-stats", "-f", str(f), "-t", "8", "-p", "4"]) \
        == 0
    assert capsys.readouterr().out == got
    assert run_cli(["dss", "-f", str(f), "-l"]) == 0


def test_benchmark_k_and_psac_vs_dss(tmp_path, capsys):
    f = tmp_path / "t.txt"
    f.write_bytes(rep_dna(3000, unit_len=300, seed=3, mutations=3))
    assert run_cli(["benchmark-k", "-f", str(f), "--ks", "0", "4",
                    "--reps", "1", "-l"]) == 0
    rows = capsys.readouterr().out.strip().split("\n")
    assert [r.split(";")[:3] for r in rows] == [["1", "psac", "0"],
                                                ["1", "psac", "4"]]
    assert run_cli(["psac-vs-dss", "-f", str(f)]) == 0
    assert "[SUCCESS]" in capsys.readouterr().out


def test_benchmark_variants_as_jax(capsys):
    """``benchmark`` prints the JAX CLI's six construction variants in its
    order, each row ``p;name;ms`` with p = 1 (the JAX CLI given one
    device)."""
    argv = ["benchmark", "-r", "3000", "--reps", "1"]
    assert run_cli(argv) == 0
    got = [r.split(";") for r in capsys.readouterr().out.split()]
    assert run_jax_cli(argv) == 0
    want = [r.split(";") for r in capsys.readouterr().out.split()]
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert [r[1] for r in got] == [
        "sa-nolcp-reg", "sa-nolcp-fast", "sa-lcp-reg", "sa-lcp-fast",
        "sa-nolcp-arr3", "sa-nolcp-arr4"]
    assert all(r[0] == "1" and float(r[2]) > 0 for r in got)


def test_benchmark_ansv_rows_as_jax(capsys):
    """``benchmark-ansv`` prints the JAX CLI's rows (every field but the
    time) for the four engines, the spine engine on ``feq-sm`` only."""
    argv = ["benchmark-ansv", "-n", "4096", "--reps", "1", "--engines",
            "hybrid,scan,block,spine"]
    assert run_cli(argv) == 0
    got = [r.split(";") for r in capsys.readouterr().out.split()]
    assert run_jax_cli(argv) == 0
    want = [r.split(";") for r in capsys.readouterr().out.split()]
    assert [r[:5] for r in got] == [r[:5] for r in want]
    assert len(got) == 3 * 3 * 3 + 3
    assert all(float(r[5]) > 0 for r in got)


# ---------------------------------------------------------------------------
# --devices P: a mesh of P shards, all on --device
# ---------------------------------------------------------------------------

_MATCHED = r"bulk_locate: (\d+) patterns, (\d+) matched"


def test_desa_cli_on_a_mesh_as_jax(tmp_path, capsys):
    """``desa --devices 4`` builds, saves, queries and loads as the JAX
    CLI at ``--devices 4``: byte-identical files, the same matched
    counts, each loading the other's index."""
    import re

    text = rand_dna(3000, seed=21)
    f = tmp_path / "t.txt"
    f.write_bytes(text)
    pat = tmp_path / "p.txt"
    run_cli(["mkpattern", "-f", str(f), "-n", "40", "-l", "12", "-o",
             str(pat)])
    with open(pat, "ab") as fp:
        fp.write(b"ACGTACGTACGTACGTACGT\n" + text[1490:1510] + b"\n")
    tpre, jpre = str(tmp_path / "t"), str(tmp_path / "j")
    base = ["desa", "-f", str(f), "-q", str(pat), "--reps", "1"]
    capsys.readouterr()
    assert run_cli(base + ["-o", tpre, "--devices", "4"]) == 0
    got = re.findall(_MATCHED, capsys.readouterr().err)
    assert run_jax_cli(base + ["-o", jpre], devices=4) == 0
    want = re.findall(_MATCHED, capsys.readouterr().err)
    assert got == want and len(got) == 1 and int(got[0][0]) == 42
    _same_files(jpre, tpre, (".sa64", ".lcp64", ".lc64", ".alpha"))
    for pre, tli in ((jpre, "tldt"), (tpre, "tllt")):
        assert run_cli(base + ["--load", pre, "--tli", tli,
                               "--devices", "4"]) == 0
        assert re.findall(_MATCHED, capsys.readouterr().err) == want
    assert run_jax_cli(base + ["--load", tpre], devices=4) == 0
    assert re.findall(_MATCHED, capsys.readouterr().err) == want


def test_psac_cli_on_a_mesh_as_jax(tmp_path):
    """``psac --devices 2 -l -o`` writes the JAX CLI's files at
    ``--devices 2``, byte for byte, from ``-r`` and from ``-f``."""
    jpre, tpre, fpre = (str(tmp_path / x) for x in ("jax", "torch", "file"))
    argv = ["psac", "-r", "3000", "--seed", "5", "-l", "-o"]
    assert run_jax_cli(argv + [jpre], devices=2) == 0
    assert run_cli(argv + [tpre, "--devices", "2"]) == 0
    f = tmp_path / "r.txt"
    f.write_bytes(rand_dna(3000, seed=5))
    assert run_cli(["psac", "-f", str(f), "-l", "-o", fpre, "-c",
                    "--devices", "2"]) == 0
    _same_files(jpre, tpre, (".sa64", ".lcp64", ".alpha"))
    _same_files(jpre, fpre, (".sa64", ".lcp64", ".alpha"))
    assert run_cli(["psac", "-f", str(f), "-t", "--devices", "2"]) == 0
    g = tmp_path / "ss.txt"
    g.write_bytes(b"banana\nana\nnab\nbanana\n")
    assert run_cli(["gsac", "-f", str(g), "-c", "--devices", "2"]) == 0


def test_benchmark_rows_print_the_devices(capsys):
    """``benchmark``, ``benchmark-k`` and ``benchmark-ansv`` print P in
    their device column; ``benchmark-ansv`` on a mesh runs the routed
    pipeline once per input and pair, as the JAX CLI does."""
    assert run_cli(["benchmark", "-r", "2000", "--reps", "1",
                    "--devices", "2"]) == 0
    rows = [r.split(";") for r in capsys.readouterr().out.split()]
    assert [r[0] for r in rows] == ["2"] * 6
    assert run_cli(["benchmark-k", "-r", "2000", "--ks", "0", "4",
                    "--reps", "1", "--devices", "3"]) == 0
    rows = [r.split(";") for r in capsys.readouterr().out.split()]
    assert [r[:3] for r in rows] == [["3", "psac", "0"], ["3", "psac", "4"]]
    argv = ["benchmark-ansv", "-n", "4096", "-i", "peaks", "--reps", "1"]
    assert run_cli(argv + ["--devices", "2"]) == 0
    got = [r.split(";") for r in capsys.readouterr().out.split()]
    assert run_jax_cli(argv, devices=2) == 0
    want = [r.split(";") for r in capsys.readouterr().out.split()]
    assert [r[:5] for r in got] == [r[:5] for r in want]
    assert [r[:3] for r in got] == [["4096", "2", "default"]] * 3


def test_devices_without_a_device_takes_the_cards():
    """Without ``--device`` the P shards go on the first P cards: with
    fewer cards ``make_mesh`` raises rather than guessing a device."""
    from psac_tpu_torch.cli import main

    if torch.cuda.is_available() and torch.cuda.device_count() >= 64:
        pytest.skip("this machine has 64 cards")
    with pytest.raises(ValueError, match="CUDA device"):
        main(["psac", "-r", "100", "--devices", "64"])


def test_cli_errors(tmp_path):
    with pytest.raises(SystemExit):
        run_cli(["psac", "-l"])  # neither -f nor -r
    f = tmp_path / "bad.txt"
    f.write_bytes(rand_dna(100, seed=1) + b"\x00" + rand_dna(50, seed=2))
    with pytest.raises(ValueError, match="NUL"):
        run_cli(["psac", "-f", str(f), "-l"])


# ---------------------------------------------------------------------------
# byte-identical files, and each package loads the other's
# ---------------------------------------------------------------------------

def test_psac_files_equal_jax(tmp_path):
    """``psac -r 3000 --seed 5 -l -o`` of both CLIs, and ``psac -f`` of the
    same bytes, write byte-identical ``.sa64/.lcp64/.alpha``."""
    jpre, tpre, fpre = (str(tmp_path / x) for x in ("jax", "torch", "file"))
    assert run_jax_cli(["psac", "-r", "3000", "--seed", "5", "-l",
                        "-o", jpre]) == 0
    assert run_cli(["psac", "-r", "3000", "--seed", "5", "-l", "-o",
                    tpre]) == 0
    f = tmp_path / "r.txt"
    f.write_bytes(rand_dna(3000, seed=5))
    assert run_cli(["psac", "-f", str(f), "-l", "-o", fpre]) == 0
    _same_files(jpre, tpre, (".sa64", ".lcp64", ".alpha"))
    _same_files(jpre, fpre, (".sa64", ".lcp64", ".alpha"))


def test_artifacts_load_across_packages(tmp_path, mesh1):
    import psac_tpu.io as j_io
    from psac_tpu.models.suffix_array import build_suffix_array as j_build

    import psac_tpu_torch.io as t_io
    from psac_tpu_torch.models.suffix_array import (SuffixArray,
                                                    build_suffix_array)

    text = rep_dna(2500, unit_len=250, seed=4, mutations=3)
    jres = j_build(text, mesh=mesh1)
    tres = build_suffix_array(text, "cpu")
    j_io.write_suffix_array(str(tmp_path / "j"), jres)
    t_io.write_suffix_array(str(tmp_path / "t"), tres)
    _same_files(str(tmp_path / "j"), str(tmp_path / "t"),
                (".sa64", ".lcp64", ".alpha"))
    a = t_io.read_suffix_array(str(tmp_path / "j"))
    b = j_io.read_suffix_array(str(tmp_path / "t"))
    for got, want in ((a, jres), (b, tres)):
        np.testing.assert_array_equal(got.sa, want.sa)
        np.testing.assert_array_equal(got.lcp, want.lcp)
        np.testing.assert_array_equal(got.alphabet.chars,
                                      want.alphabet.chars)
        np.testing.assert_array_equal(got.alphabet.mapping,
                                      want.alphabet.mapping)
        assert got.alphabet.bits_per_char == want.alphabet.bits_per_char
    # an SA-only artifact: no .lcp64 written, none read
    t_io.write_suffix_array(str(tmp_path / "s"), SuffixArray(
        sa=tres.sa, lcp=None, alphabet=tres.alphabet, n=tres.n))
    assert not (tmp_path / "s.lcp64").exists()
    assert t_io.read_suffix_array(str(tmp_path / "s")).lcp is None
    # an artifact with an Lc array: both write .lc64 alike, neither reads it
    with_lc = types.SimpleNamespace(sa=tres.sa, lcp=tres.lcp,
                                    lc=np.arange(len(text)) % 4,
                                    alphabet=tres.alphabet)
    t_io.write_suffix_array(str(tmp_path / "c"), with_lc)
    j_io.write_suffix_array(str(tmp_path / "d"), with_lc)
    _same_files(str(tmp_path / "c"), str(tmp_path / "d"),
                (".sa64", ".lcp64", ".lc64", ".alpha"))
    assert not hasattr(t_io.read_suffix_array(str(tmp_path / "c")), "lc")


@pytest.mark.parametrize("tli", ["tllt", "tldt"])
def test_desa_index_across_packages(tmp_path, mesh1, tli):
    """A DESA index written by either package loads in the other and
    answers the same ``bulk_locate``; both write byte-identical files."""
    from psac_tpu.models import desa as j_desa

    from psac_tpu_torch.models import desa as t_desa

    text = rand_dna(2500, seed=12)
    kw = dict(tli=tli, maxsize=16) if tli == "tldt" else {}
    jd = j_desa.build_desa(text, mesh=mesh1, **kw)
    td = t_desa.build_desa(text, "cpu", **kw)
    jpre, tpre = str(tmp_path / "j"), str(tmp_path / "t")
    j_desa.write_desa(jd, jpre)
    t_desa.write_desa(td, tpre)
    _same_files(jpre, tpre, (".sa64", ".lcp64", ".lc64", ".alpha"))
    rng = np.random.RandomState(3)
    pats = [text[s:s + ln] for ln in (4, 9, 20, 33)
            for s in rng.randint(0, len(text) - ln, 6)] + [b"ACGT" * 9, b""]
    want = jd.bulk_locate(pats)
    t_from_j = t_desa.read_desa(text, jpre, "cpu", **kw)
    j_from_t = j_desa.read_desa(text, tpre, mesh=mesh1, **kw)
    np.testing.assert_array_equal(t_from_j.bulk_locate(pats), want)
    np.testing.assert_array_equal(j_from_t.bulk_locate(pats), want)
    np.testing.assert_array_equal(td.bulk_locate(pats), want)
    f = tmp_path / "t.txt"
    f.write_bytes(text)
    from_file = t_desa.read_desa_from_file(str(f), jpre, "cpu", **kw)
    np.testing.assert_array_equal(from_file.bulk_locate(pats), want)
    built = t_desa.build_desa_from_file(str(f), "cpu", **kw)
    np.testing.assert_array_equal(built.bulk_locate(pats), want)
    with pytest.raises(ValueError, match="index built for"):
        t_desa.read_desa(text[:-1], jpre, "cpu")


GSA_FILES = {
    "trailing_newline": b"banana\nana\nnab\nbanana\n",
    "no_trailing_newline": b"banana\nana\nnab\nbanana",
    "empty_lines": b"\n\nACGTTGCA\n\n\nCCGTA\nACG\n\n",
    "one_string": rand_dna(700, seed=9),
    "random_set": b"\n".join(rand_dna(80 + 7 * i, seed=i) for i in range(30)),
}


@pytest.mark.parametrize("name", sorted(GSA_FILES))
def test_gsac_file_vs_jax(tmp_path, mesh1, name):
    """``gsac -f -o`` writes what the JAX package's
    ``build_gsa_from_file(mesh=mesh1)`` gives, and the device state of the
    port's ``build_gsa_from_file`` equals the JAX package's."""
    import jax
    from psac_tpu.models.gsa import build_gsa_from_file as j_from_file

    from psac_tpu_torch.io import read_u64
    from psac_tpu_torch.models.gsa import build_gsa_from_file

    f = tmp_path / "ss.txt"
    f.write_bytes(GSA_FILES[name])
    pre = str(tmp_path / "g")
    assert run_cli(["gsac", "-f", str(f), "-c", "-o", pre]) == 0
    jd = j_from_file(str(f), mesh=mesh1)
    want = jd.materialize()
    np.testing.assert_array_equal(read_u64(pre + ".gsa64"), want.sa)
    np.testing.assert_array_equal(read_u64(pre + ".glcp64"), want.lcp)
    td = build_gsa_from_file(str(f), "cpu")
    assert (td.n, td.N) == (jd.n, jd.N)
    np.testing.assert_array_equal(td.lens, jd.lens)
    for key in ("sa", "lcp", "eos", "xs"):
        got = getattr(td, key).numpy()
        ref = np.asarray(jax.device_get(getattr(jd, key)))
        assert got.dtype == ref.dtype, key
        np.testing.assert_array_equal(got, ref, err_msg=key)


def test_construct_from_file_state_vs_jax(tmp_path, mesh1):
    """``construct_from_file``'s whole padded state (SA, LCP, ISA, the
    staged codes) equals the JAX package's, and equals the in-memory
    build's."""
    import jax
    from psac_tpu.models.suffix_array import construct_from_file as j_cff

    from psac_tpu_torch.models.suffix_array import (construct_device,
                                                    construct_from_file,
                                                    encode_and_shard)

    text = rep_dna(3000, unit_len=300, seed=8, mutations=4)
    f = tmp_path / "t.txt"
    f.write_bytes(text)
    tdsa, txs = construct_from_file(str(f), "cpu")
    jdsa, jxs = j_cff(str(f), mesh=mesh1)
    assert (tdsa.n, tdsa.N) == (jdsa.n, jdsa.N)
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jax.device_get(jxs)))
    for key in ("sa", "lcp", "isa"):
        got = getattr(tdsa, key).numpy()
        ref = np.asarray(jax.device_get(getattr(jdsa, key)))
        assert got.dtype == ref.dtype, key
        np.testing.assert_array_equal(got, ref, err_msg=key)
    xs, alpha, n, N = encode_and_shard(text, "cpu")
    assert torch.equal(xs, txs)
    assert torch.equal(construct_device(xs, alpha, n, N).sa, tdsa.sa)
    np.testing.assert_array_equal(tdsa.alphabet.chars,
                                  jdsa.alphabet.chars)


@pytest.mark.parametrize("which", ["sa", "gsa"])
def test_nul_byte_raises_as_in_jax(tmp_path, mesh1, which):
    from psac_tpu.models.gsa import build_gsa_from_file as j_gsa
    from psac_tpu.models.suffix_array import construct_from_file as j_sa

    from psac_tpu_torch.models.gsa import build_gsa_from_file
    from psac_tpu_torch.models.suffix_array import construct_from_file

    f = tmp_path / "nul.txt"
    f.write_bytes(b"ACGT\nAC\x00GT\nTTA\n")
    t_fn, j_fn = (construct_from_file, j_sa) if which == "sa" else \
        (build_gsa_from_file, j_gsa)
    with pytest.raises(ValueError) as te:
        t_fn(str(f), "cpu")
    with pytest.raises(ValueError) as je:
        j_fn(str(f), mesh=mesh1)
    assert str(te.value) == str(je.value)
    e = tmp_path / "empty.txt"
    e.write_bytes(b"\n\n\n")
    with pytest.raises(ValueError, match="no string content"):
        build_gsa_from_file(str(e), "cpu")
