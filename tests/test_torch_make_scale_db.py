"""The port's scripts/make_scale_db.py: at a tiny --target-kmers its
scale_db.npz arrays and function.index equal the JAX script's (run in a
subprocess, since it imports the JAX package), uniform and skewed; and
the seeded in-memory generator ``scale_db`` gives exactly the keys asked
for, distinct and sorted, at the skew asked for."""

import os
import subprocess
import sys

import numpy as np
import pytest

from close_kmers_tpu_torch.core import engine as T
from close_kmers_tpu_torch.params import LO_CARD
from close_kmers_tpu_torch.scripts import make_scale_db as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--target-kmers", "6000", "--n-genomes", "6", "--prot-len", "60",
        "--n-funcs", "7"]


@pytest.mark.parametrize("bias", [[], ["--aa-bias"]])
def test_script_output_equals_jax_script(tmp_path, bias):
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    env = dict(os.environ, CLOSE_KMERS_JAX_PLATFORM="cpu",
               JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "make_scale_db.py"),
         "--out", str(jax_out), *ARGS, *bias], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert M.main(["--out", str(port_out), *ARGS, *bias]) == 0
    want = np.load(jax_out / "scale_db.npz")
    got = np.load(port_out / "scale_db.npz")
    assert sorted(want.files) == sorted(got.files) == \
        ["avg_off", "fi", "keys", "oi", "wt"]
    assert len(got["keys"]) > 3000
    for k in want.files:
        assert want[k].dtype == got[k].dtype, k
        assert np.array_equal(want[k].view(np.uint8), got[k].view(np.uint8)), k
    assert (jax_out / "function.index").read_bytes() == \
        (port_out / "function.index").read_bytes()
    for d in (jax_out, port_out):
        assert sorted(os.listdir(d / "corpus")) == [f"genome{g}.fa"
                                                   for g in range(6)]


@pytest.mark.parametrize("bias", [False, True])
def test_scale_db_exact_sorted_and_seeded(bias):
    db = M.scale_db(50_000, aa_bias=bias, n_funcs=300, seed=5, device="cpu")
    assert len(db) == 50_000
    assert (np.diff(db.keys) > 0).all() and db.keys[0] >= 0
    assert db.keys[-1] < 20 ** 8
    assert 0 <= db.fi.min() and db.fi.max() < 300 and (db.oi == -1).all()
    assert 0 <= db.avg_off.min() and db.avg_off.max() < M.PROT_LEN - 8
    assert 0.1 <= db.wt.min() and db.wt.max() < 3.0
    assert len(db.functions) == 300
    again = M.scale_db(50_000, aa_bias=bias, n_funcs=300, seed=5,
                       device="cpu")
    for f in ("keys", "fi", "avg_off", "wt"):
        assert np.array_equal(getattr(db, f), getattr(again, f)), f


def test_scale_db_skew_deepens_buckets():
    """At AA_FREQ the common residues' buckets fill first: the deepest
    bucket and sub-bucket outgrow the uniform DB's, and the first residue
    follows the frequencies."""
    uni = M.scale_db(200_000, seed=1, device="cpu")
    skew = M.scale_db(200_000, aa_bias=True, seed=1, device="cpu")
    su, ss = T.tier_stats(uni), T.tier_stats(skew)
    assert ss.max_bucket > su.max_bucket and ss.n_sub < su.n_sub
    first = np.bincount(skew.keys // (20 ** 7), minlength=20) / len(skew)
    assert np.abs(first - M.AA_FREQ).max() < 0.01
    uni_first = np.bincount(uni.keys // (20 ** 7), minlength=20) / len(uni)
    assert np.abs(uni_first - 0.05).max() < 0.01
    assert int(skew.hi.max()) < 20 ** 5 and int(skew.lo.max()) < LO_CARD


@pytest.mark.parametrize("bias,block", [(False, 1 << 24), (True, 7_001)])
def test_scale_mapping_csr_equals_key_by_key(monkeypatch, bias, block):
    """scale_mapping's CSR (built in blocks of MAPPING_BLOCK keys, here
    also in odd blocks) equals the CSR of a mapping built key by key with
    add_fam_mapping under the JAX scale serve's rule: degree 1 + lo % 3,
    families fi * 3 + j; its families are that script's."""
    from close_kmers_tpu_torch.db.family_db import KmerFamilyMapping
    monkeypatch.setattr(M, "MAPPING_BLOCK", block)
    db = M.scale_db(30_000, aa_bias=bias, n_funcs=50, seed=4, device="cpu")
    got = M.scale_mapping(db)
    want = KmerFamilyMapping()
    for k, lo, fi in zip(db.keys.tolist(), db.lo.tolist(), db.fi.tolist()):
        for j in range(1 + lo % 3):
            want.add_fam_mapping(fi * 3 + j, k)
    for g, w in zip(got.fam_csr(), want.fam_csr()):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert np.bincount(np.diff(got.fam_csr()[1])).tolist()[0] == 0
    assert len(got.families) == 150
    f = got.families[7]
    assert (f.pgf, f.plf, f.genus_id, f.function, f.family_id) == \
        ("PGF_00000007", "PLF_2_00000007", 2, "Synthetic function 2", 7)
