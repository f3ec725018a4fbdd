"""The port's CLI tools against the JAX package's, in process, on
``tests/test_cli.py``'s corpus: each tool's stdout, stderr and files must
be byte-identical.  The port's tools that annotate run with ``--device
cpu``; without it they default to ``cuda`` and raise where torch sees no
card."""

import contextlib
import io
import sys

import numpy as np
import pytest
import torch

from close_kmers_tpu.cli import build_db as JBD, kclient as JKC, \
    kmerge as JKM, propagate_names as JPN, tools as JT
from close_kmers_tpu.ops import encoder as E
from close_kmers_tpu_torch.cli import build_db as TBD, kclient as TKC, \
    kmerge as TKM, propagate_names as TPN, tools as TT

from test_torch_host import _files_of, annotated_genomes, canned_server


def run(main, argv, stdin=b""):
    """``main(argv)`` in this process: (return code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    old_stdin = sys.stdin
    sys.stdin = io.TextIOWrapper(io.BytesIO(stdin))
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    finally:
        sys.stdin = old_stdin
    return rc, out.getvalue(), err.getvalue()


def same(jax_argv, port_argv, jax_main, port_main, stdin=b""):
    """Both tools' (rc, stdout, stderr), held equal; returns the port's."""
    want = run(jax_main, jax_argv, stdin)
    got = run(port_main, port_argv, stdin)
    assert got == want
    return got


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """test_cli.py's corpus (one 60-aa Amidase in five genomes) and its
    data dir, built by the JAX tool."""
    rng = np.random.default_rng(5)
    tmp = tmp_path_factory.mktemp("cli")
    prot = "".join(rng.choice(list(E.PROT_ALPHA), size=60))
    files = []
    for g in range(5):
        p = tmp / f"g{g}.fa"
        p.write_text(f">fig|{g}.1.peg.1 Amidase\n{prot}\n")
        files.append(str(p))
    data = tmp / "data"
    rc, _, err = run(JBD.main, [str(data)] + [f"--fasta={f}" for f in files])
    assert rc == 0 and "Kept 53 kmers" in err
    return tmp, data, prot, files


def test_kfile_matches_jax(built):
    tmp, data, prot, _ = built
    fa = (f">p1\n{prot}\n>p2 desc\n{prot[5:50]}XX{prot[::-1]}\n>p3\n\n"
          f">p4\n{prot[:20].lower()}\n").encode()
    for extra in ([], ["--min-hits", "3", "--max-gap", "10"]):
        _, out, _ = same(["kfile", str(data)] + extra,
                         ["kfile", str(data), "--device", "cpu"] + extra,
                         JT.main, TT.main, stdin=fa)
    assert out.startswith("CALL\t0\t58\t52\t0\tAmidase\t")
    assert "OTU-COUNTS\tp1[60]\t52--1" in out


def test_fastq_to_protein_matches_jax(tmp_path):
    rng = np.random.default_rng(8)
    reads = ["".join(rng.choice(list("ACGTN"), size=int(n)))
             for n in rng.integers(30, 200, size=12)]
    fq = tmp_path / "r.fq"
    fq.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                          for i, r in enumerate(reads)))
    _, out, _ = same(["fastq_to_protein", str(fq)],
                     ["fastq_to_protein", str(fq)], JT.main, TT.main)
    assert out.count(">") > 5
    files = []
    for M in (JT, TT):
        o = tmp_path / f"{M.__name__}.fa"
        assert run(M.main, ["fastq_to_protein", str(fq), "-o", str(o)])[0] == 0
        files.append(o.read_text())
    assert files[0] == files[1] == out


@pytest.mark.parametrize("tool,text", [
    ("validate_fasta", ">a\nMKLV\n>b\nACDE\n>c\nMM\n"),
    ("validate_fasta", "MKLV\n"),
    ("validate_fasta", ">a\nMK LV\n"),
    ("validate_fastq", "@r1\nACGT\n+\nIIII\n@r2\nAC\n+\nII\n"),
    ("validate_fastq", "@r1\nACGT\n+\nII\n"),
])
def test_validators_match_jax(tmp_path, tool, text):
    path = tmp_path / "in.txt"
    path.write_text(text)
    _, out, _ = same([tool, str(path)], [tool, str(path)], JT.main, TT.main)
    assert out.startswith("valid\t")


def test_unique_prots_matches_jax(built, tmp_path):
    """The port groups by the hit arrays of annotate_with_hits (it keeps
    no hits_compact); the groups and their order equal JAX's."""
    tmp, data, prot, _ = built
    fa = tmp_path / "u.fa"
    fa.write_text(f">a\n{prot}\n>b\n{prot}\n>c\nMMMMMMMMMMMM\n"
                  f">d\n{prot[:30]}\n>e\n{prot[:30]}KK\n>f\n\n")
    _, out, _ = same(["unique_prots", str(data), str(fa)],
                     ["unique_prots", str(data), str(fa), "--device", "cpu"],
                     JT.main, TT.main)
    lines = out.strip().split("\n")
    assert "2\ta b" in lines and "2\tc f" in lines      # c, f: no hits


def test_build_db_recall_and_validation_match_jax(tmp_path):
    """The builder, its recall (Calls/, New/) and validation lines, on
    ten genomes whose proteins recur with point mutations.  Each tool runs
    in a process of its own: run_validation binds sys.stdout as its
    default stream when its module is first imported."""
    import os
    import re
    import subprocess
    rng = np.random.default_rng(12)
    files = annotated_genomes(rng, tmp_path, n_genomes=10, p_mut=0.05)
    vdir = tmp_path / "valid"
    (vdir / "anno").mkdir(parents=True)
    (vdir / "seq").mkdir()
    for i in range(2):
        text = open(files[i]).read()
        (vdir / "seq" / f"s{i}").write_text(text)
        (vdir / "anno" / f"a{i}").write_text("".join(
            f"{ln[1:].split()[0]}\t{ln.split(' ', 1)[1] if i else 'x'}\n"
            for ln in text.splitlines() if ln.startswith(">")))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu")
    got = []
    for module, extra in (("close_kmers_tpu", []),
                          ("close_kmers_tpu_torch", ["--device", "cpu"])):
        out = tmp_path / module
        argv = ([str(out / "data")] + [f"--fasta={f}" for f in files]
                + ["--min-reps-required", "5", "--mem-map",
                   f"--recall-output={out / 'recall'}",
                   f"--validation-folder={vdir}", "--validation-verbose",
                   "--recall-min-hits", "3"] + extra)
        r = subprocess.run([sys.executable, "-m", f"{module}.cli.build_db",
                            *argv], capture_output=True, env=env, text=True,
                           timeout=600)
        assert r.returncode == 0, r.stderr
        kept = re.findall(r"^(?:kept|Kept|distinct|num_seqs).*$", r.stderr,
                          re.M)
        got.append((r.stdout, kept, _files_of(out)))
    assert got[0] == got[1]
    stdout, kept, files_out = got[1]
    assert "correct=" in stdout and "incorrect\t" in stdout
    assert len(kept) == 4
    assert sum(k.startswith("recall/Calls/") for k in files_out) == 10


def test_kmerge_and_propagate_names_match_jax(tmp_path):
    from test_kmerge import setup_inputs
    from test_propagate_names import write_release
    tmp = setup_inputs(tmp_path)
    for extra in ([], ["--use-kmer-counts"], ["-a", "-r", "2"],
                  ["--no-header"]):
        argv = [str(tmp / "res.list"), str(tmp / "sus.list"),
                "-d", str(tmp / "KMERS")] + extra
        _, out, _ = same(argv, argv, JKM.main, TKM.main)
        assert out
    pegsyn = [(f"md5_{i}", [f"fig|1.1.peg.{i}"]) for i in range(4)]
    old = write_release(tmp_path, "old", "G", pegsyn, [
        ("GFOLD1", "fig|1.1.peg.0", "fnA", "1", "G"),
        ("GFOLD1", "fig|1.1.peg.1", "fnA", "1", "G"),
        ("GFOLD2", "fig|1.1.peg.2", "fnB", "2", "G")])
    new = write_release(tmp_path, "new", "G", pegsyn, [
        ("GFNEW7", "fig|1.1.peg.0", "fnA", "1", "G"),
        ("GFNEW7", "fig|1.1.peg.1", "fnA", "1", "G"),
        ("GFNEW8", "fig|1.1.peg.3", "fnC", "3", "G")])
    for ft in ("global", "local"):
        argv = [ft, *old, *new]
        _, out, _ = same(argv, argv, JPN.main, TPN.main)
        assert "GFNEW7" in out or "G.1" in out


def test_kclient_matches_jax(tmp_path):
    body = tmp_path / "q.fa"
    body.write_text(">p1\nMKLV\n>p2\nACDE\n")
    resp = (b"HTTP/1.1 200 OK\nContent-length: 0\n\n"
            b"PROTEIN-ID\tp1\t4\nHIT\t1\t2\t3\tfnB\nHIT\t1\t2\t3\tfnA\n"
            b"HIT\t4\t5\t6\tfnA\nCALL\t0\t9\t2\t1\tfnA\t2.0\n")
    port, seen, stop = canned_server(resp)
    try:
        for extra in ([], ["--fold-hits"],
                      ["--endpoint", "/lookup", "--param", "details=1"]):
            argv = ["127.0.0.1", str(port), str(body)] + extra
            _, out, _ = same(argv, argv, JKC.main, TKC.main)
            assert out
    finally:
        stop()
    assert len(seen) == 6 and seen[0] == seen[1]


def test_tools_default_to_cuda_and_raise_without_card(built, monkeypatch,
                                                      tmp_path):
    tmp, data, prot, files = built
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fa = tmp_path / "u.fa"
    fa.write_text(f">a\n{prot}\n")
    for argv in (["kfile", str(data)], ["unique_prots", str(data), str(fa)]):
        with pytest.raises(RuntimeError, match="is_available"):
            run(TT.main, argv, stdin=fa.read_bytes())
    out = tmp_path / "d"
    with pytest.raises(RuntimeError, match="is_available"):
        run(TBD.main, [str(out), f"--fasta={files[0]}",
                       f"--recall-output={tmp_path / 'r'}"])
    assert not out.exists()                    # raised before the build
    # without recall or validation the builder needs no device
    assert run(TBD.main, [str(out)] + [f"--fasta={f}" for f in files])[0] == 0
