"""Non-family server mode through the port, byte for byte against the JAX
server on the same data dir (one with no families.dat, so family mode is
off and /lookup answers per-peg hit rows, lookup_request.cc:380-397):
tests/test_server_pegmode.py's two cases, and a twelve-request sequence
of /add, /lookup in three modes, /query under five parameter sets,
/matrix, a second /add and /lookup again."""

import numpy as np
import pytest

from close_kmers_tpu.cli.kser import load_server_context as jax_load
from close_kmers_tpu.db.signature_db import SignatureDB, write_index_file
from close_kmers_tpu.ops import encoder as E
from close_kmers_tpu.params import K
from close_kmers_tpu_torch.cli import kser

from test_server import post
from test_torch_server import _serve


@pytest.fixture(scope="module")
def peg_dir(tmp_path_factory):
    """tests/test_server_pegmode.py's data dir: one 80-aa protein's kmers
    under one function, no families.dat."""
    rng = np.random.default_rng(77)
    d = tmp_path_factory.mktemp("pegdata")
    prot = "".join(rng.choice(list(E.PROT_ALPHA), size=80))
    entries = {}
    for i in range(len(prot) - K + 1):
        entries.setdefault(prot[i:i + K], (prot[i:i + K], 10, 0, 1.0, -1))
    db = SignatureDB.from_entries(entries.values(), functions=["some fn"])
    db.save_npz(str(d / "signature_db.npz"))
    write_index_file(str(d / "function.index"), ["some fn"])
    write_index_file(str(d / "otu.index"), [])
    return str(d), prot


@pytest.fixture
def servers(peg_dir):
    """Fresh servers on the data dir, the port's (cpu) and the JAX
    package's: each test's /add starts from the same state."""
    d, prot = peg_dir
    ctxs = [kser.load_server_context(d, batch_size=64, device="cpu"),
            jax_load(d, batch_size=64)]
    assert not any(c.family_mode for c in ctxs)
    running = [_serve(c) for c in ctxs]
    yield [port for port, _ in running], prot
    for _, stop in running:
        stop()


def both(ports, path: str, body: bytes) -> str:
    """The port's answer, after checking it equals the JAX server's."""
    got, want = (post(p, path, body) for p in ports)
    assert got == want, path
    return got


def test_peg_mode_lookup_matches_jax(servers):
    ports, prot = servers
    body = f">pegA\n{prot}\n>pegB\n{prot[:40]}\n".encode()
    assert "200 OK" in both(ports, "/add?silent=1", body)
    resp = both(ports, "/lookup", f">query\n{prot[5:60]}\n".encode())
    lines = resp.split("\n")
    assert "query" in lines
    counts = {r[0]: int(r[1]) for r in
              (ln.split("\t") for ln in lines if ln.startswith("peg"))}
    assert counts["pegA"] > counts.get("pegB", 0) > 0
    assert resp.rstrip().endswith("//")


def test_engine_params_via_query_match_jax(servers):
    ports, prot = servers
    body = f">q\n{prot}\n".encode()
    assert "CALL\t" not in both(ports, "/query?min_hits=999", body)
    assert "CALL\t" in both(ports, "/query?min_hits=3", body)
    assert "CALL\t" not in both(ports, "/query?min_weighted_hits=10000",
                                body)
    assert "CALL\t" in both(ports, "/query?max_gap=1", body)


def test_request_sequence_matches_jax(servers):
    """/add, /lookup (plain, find_best_match=1, kmer_hit_threshold=1),
    /query (min_hits 999 and 3, min_weighted_hits=10000, max_gap=1,
    hits=1), /matrix, /add, /lookup: every answer byte-identical."""
    ports, prot = servers
    pegs = f">pegA\n{prot}\n>pegB\n{prot[:40]}\n".encode()
    query = f">query\n{prot[5:60]}\n>other\n{prot[30:]}\n".encode()
    body = f">q\n{prot}\n".encode()
    seq = [("/add?silent=1", pegs), ("/lookup", query),
           ("/lookup?find_best_match=1", query),
           ("/lookup?kmer_hit_threshold=1", query),
           ("/query?min_hits=999", body), ("/query?min_hits=3", body),
           ("/query?min_weighted_hits=10000", body),
           ("/query?max_gap=1", body), ("/query?hits=1", body),
           ("/matrix", pegs),
           ("/add", f">pegC\n{prot[10:70]}\n".encode()),
           ("/lookup", query)]
    got = [both(ports, path, payload) for path, payload in seq]
    assert all("200 OK" in g for g in got)
    assert "pegC" in got[-1] and "pegC" not in got[1]
    assert "CALL\t" in got[5] and "CALL\t" not in got[4]
    assert "pegA\tpegB" in got[9] or "pegB\tpegA" in got[9], got[9]
