"""The port's sharded serving step across real processes: gloo ranks on
the CPU, each running close_kmers_tpu_torch.scripts.multiproc_worker,
each checking the whole global outputs against the single-device probe
and the same step on a one-process 1 x 1 mesh; and the host helpers of
parallel/multihost.py against the JAX package's."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from close_kmers_tpu.parallel import multihost as JH
from close_kmers_tpu_torch.parallel import multihost as TH
from close_kmers_tpu_torch.parallel.sharding import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(world: int, extra=(), timeout=300):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "close_kmers_tpu_torch.scripts."
         "multiproc_worker", str(r), str(world), str(port), *extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return outs


def test_two_ranks_match_one_process():
    """Two gloo ranks, a 1 x 2 mesh, on the shallow (payload-wide shards)
    and deep (sub-bucket shards) DBs."""
    outs = _run_ranks(2)
    for r, out in enumerate(outs):
        assert f"rank {r} [shallow/wide]: OK" in out, out
        assert f"rank {r} [deep/sub]: OK" in out, out
        assert f"rank {r}: OK" in out, out


@pytest.mark.slow
def test_four_ranks_two_data_rows():
    """Four gloo ranks, a 2 x 2 mesh (a process group per data row)."""
    outs = _run_ranks(4, ("--n-data", "2"), timeout=600)
    for r, out in enumerate(outs):
        assert f"rank {r} [shallow/wide]: OK" in out, out
        assert f"rank {r} [deep/sub]: OK" in out, out


@pytest.mark.slow
def test_two_ranks_midsize():
    """Two ranks over the 10M-key DB of uneven hi occupancy."""
    outs = _run_ranks(2, ("--midsize",), timeout=1800)
    for r, out in enumerate(outs):
        assert f"rank {r} [midsize/" in out, out
        assert f"rank {r}: OK" in out, out


@pytest.mark.parametrize("size,parts", [(0, 1), (1, 4), (1000, 3),
                                        (4097, 8)])
def test_partition_file_ranges_matches_jax(size, parts):
    assert TH.partition_file_ranges(size, parts) == \
        JH.partition_file_ranges(size, parts)


def test_read_lines_in_range_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    path = tmp_path / "lines.txt"
    lines = ["".join(rng.choice(list("ACGT>x é"), size=int(n)))
             for n in rng.integers(0, 40, size=200)]
    path.write_bytes("\n".join(lines).encode("latin-1", "replace"))
    size = path.stat().st_size
    for parts in (1, 3, 7):
        got, want = [], []
        for a, b in TH.partition_file_ranges(size, parts):
            got += list(TH.read_lines_in_range(str(path), a, b))
            want += list(JH.read_lines_in_range(str(path), a, b))
        assert got == want
        assert len(got) == len(lines)


def test_host_shard_matches_jax():
    items = list(range(23))
    assert TH.host_shard(items) == JH.host_shard(items) == items
    for n in (1, 2, 5):
        for pid in range(n):
            assert TH.host_shard(items, pid, n) == \
                JH.host_shard(items, pid, n)


def test_single_process_helpers(monkeypatch):
    """Without a world size nothing is joined; on a one-process mesh the
    inputs pass through and each entry's rows are addressable."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert TH.initialize("cpu") is False
    mesh = make_mesh(2, 2, devices=["cpu"] * 4)
    a = np.arange(12, dtype=np.int32).reshape(6, 2)
    assert TH.replicate_to_global(mesh, a)[0] is a
    x = torch.arange(8).reshape(8, 1)
    got = list(TH.addressable_rows(mesh, x, "both"))
    assert [idx[0] for idx, _ in got] == [slice(2 * b, 2 * b + 2)
                                          for b in range(4)]
    assert np.array_equal(np.concatenate([r for _, r in got]), x.numpy())
    rows = list(TH.addressable_rows(mesh, x, "data"))
    assert [idx[0] for idx, _ in rows] == [slice(0, 4)] * 2 \
        + [slice(4, 8)] * 2
