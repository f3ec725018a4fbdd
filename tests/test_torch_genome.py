"""Port parity for core/genome.py: the on-device six-frame translate, the
tiled carry-fixpoint program and GenomeAnnotator against the JAX package
on the same numpy-seeded DNA, and against the port's oracle.process_seq.
Zero tolerance: the whole packed call buffer word for word (f32 weights
as their bits) and the fixpoint's round count."""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from close_kmers_tpu.core import engine as JE
from close_kmers_tpu.core import genome as JG
from close_kmers_tpu.params import EngineParams
from close_kmers_tpu_torch.core import engine as TE
from close_kmers_tpu_torch.core import genome as TG
from close_kmers_tpu_torch.core import oracle as TO
from close_kmers_tpu_torch.core.api import KmerEngine
from close_kmers_tpu_torch.ops import encoder, translate

from test_engine import random_db
from test_genome import _flat, _synth
from test_torch_engine_tiers import VARIANTS
from test_torch_host import as_jax_db, as_port_db


@pytest.fixture(scope="module")
def setup():
    """tests/test_genome.py's DB (seed 11), one annotator of each
    package on it."""
    rng = np.random.default_rng(11)
    db = as_port_db(random_db(rng))
    return db, JG.GenomeAnnotator(as_jax_db(db)), \
        TG.GenomeAnnotator(db, "cpu")


def run_both(jga, tga, dna, params, call_cap=8192):
    """Both packages' packed buffer and round count for ``dna``."""
    out_w, it_w, T_w = jga.dispatch(dna, params, call_cap)
    out_g, it_g, T_g = tga.dispatch(dna, params, call_cap)
    assert T_w == T_g
    return np.asarray(out_w), int(it_w), out_g.numpy(), it_g, T_g


def oracle_calls(dna, db, params):
    calls = []
    TO.process_seq(dna, db.lookup, params, calls, None, None)
    return [(c.start, c.end, c.count, c.fI, np.float32(c.weighted))
            for c in calls]


def bits(calls):
    return [c[:4] + (np.float32(c[4]).view(np.int32),) for c in calls]


def test_codon_masks_and_aa_of_idx4():
    """The five mask words (the hi words negative as int32) and the aa
    offset of every one of the 64 codons."""
    assert np.array_equal(TG._CODON_MASKS, JG._codon_masks())
    assert (TG._CODON_MASKS < 0).any()
    i4 = np.arange(64, dtype=np.int32)
    got = TG._aa_of_idx4(torch.from_numpy(i4)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, np.asarray(JG._aa_of_idx4(jnp.asarray(i4))))
    want = encoder.AA_TO_OFFSET[translate.KGUTS_TABLE[:64]]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [3, 301, 302, 303, 3000])
@pytest.mark.parametrize("extra", [0, 7])
def test_frames_of_digits_matches_jax(n, extra):
    """Random digits with ambiguous 4s, lengths of every residue mod 3,
    and an Lpad past N // 3 (the tail padded with 20)."""
    rng = np.random.default_rng(n * 10 + extra)
    d = rng.integers(0, 5, size=n).astype(np.int32)
    Lpad = n // 3 + extra
    got = TG._frames_of_digits(torch.from_numpy(d), Lpad).numpy()
    want = np.asarray(JG._frames_of_digits(jnp.asarray(d), Lpad))
    assert got.shape == (3, Lpad)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_bases", [2000, 12 * JG.STEP],
                         ids=["one_tile", "twelve_tiles"])
@pytest.mark.parametrize("mh,gap", [(3, 200), (1, 50)])
def test_genome_calls_match_jax(setup, n_bases, mh, gap):
    """The whole [6T] ++ [5 * cap] buffer and the round count, for a
    genome within one tile a frame and one of ~12 tiles a frame."""
    db, jga, tga = setup
    rng = np.random.default_rng(n_bases + mh)
    dna = _synth(rng, db, n_bases)
    want, it_w, got, it_g, T = run_both(
        jga, tga, dna, EngineParams(min_hits=mh, max_gap=gap))
    assert np.array_equal(got, want)
    assert it_g == it_w >= 2
    assert int(got[:6 * T].sum()) > (10 if n_bases > 2000 else 0)


def test_genome_order_constraint_matches_jax(setup):
    db, jga, tga = setup
    dna = _synth(np.random.default_rng(5), db, 8 * JG.STEP)
    params = EngineParams(min_hits=2, order_constraint=1)
    want, it_w, got, it_g, T = run_both(jga, tga, dna, params)
    assert np.array_equal(got, want) and it_g == it_w
    assert int(got[:6 * T].sum()) > 0


def test_calls_of_matches_jax_and_oracle(setup):
    """calls_of (str input, then the same DNA as a uint8 digit array)
    against JAX's calls_of and the port's oracle.process_seq."""
    db, jga, tga = setup
    dna = _synth(np.random.default_rng(7), db, 5 * JG.STEP)
    params = EngineParams(min_hits=3)
    per_w, frames_w = jga.calls_of(dna, params)
    per_g, frames_g = tga.calls_of(dna, params)
    assert np.array_equal(per_g, per_w)
    assert bits(_flat(frames_g)) == bits(_flat(frames_w))
    assert bits(_flat(frames_g)) == bits(oracle_calls(dna, db, params))
    assert int(per_g.sum()) > 5
    digits = translate._DNA_CHAR[translate._to_bytes(dna)]
    per_d, frames_d = tga.calls_of(digits, params)
    assert np.array_equal(per_d, per_g)
    assert bits(_flat(frames_d)) == bits(_flat(frames_g))


def test_call_cap_escalates(setup):
    """call_cap = 2 overflows; the x4 retry ends with JAX's calls."""
    db, jga, tga = setup
    dna = _synth(np.random.default_rng(8), db, 6000)
    params = EngineParams(min_hits=1)
    out, _, T = tga.dispatch(dna, params, call_cap=2)
    assert tga.finish(out.numpy(), T, 2) is None
    per_w, frames_w = jga.calls_of(dna, params, call_cap=2)
    per_g, frames_g = tga.calls_of(dna, params, call_cap=2)
    assert np.array_equal(per_g, per_w) and int(per_g.sum()) > 2
    assert bits(_flat(frames_g)) == bits(_flat(frames_w))
    assert bits(_flat(frames_g)) == bits(oracle_calls(dna, db, params))


@pytest.mark.parametrize("dna", ["N" * 500, "ACGT" * 10, ""],
                         ids=["all_N", "short", "empty"])
def test_ambiguous_short_and_empty(setup, dna):
    """The JAX tests skip the empty string; here both packages take it
    and the port pins what JAX answers."""
    db, jga, tga = setup
    params = EngineParams()
    want, it_w, got, it_g, _T = run_both(jga, tga, dna, params)
    assert np.array_equal(got, want) and it_g == it_w
    per_g, frames_g = tga.calls_of(dna, params)
    assert bits(_flat(frames_g)) == bits(oracle_calls(dna, db, params))
    assert int(per_g.sum()) == len(_flat(frames_g))


@pytest.mark.parametrize("tier", ["binary_search", "sub_blocks"])
def test_genome_on_other_tiers_matches_jax(setup, tier):
    """Built from an object with a ``ddb``, the annotator probes that
    table: the program gives JAX's buffer on every tier."""
    db, _jga, _tga = setup
    kw = VARIANTS[tier]
    jd = JE.DeviceDB.from_db(as_jax_db(db), **kw)
    td = TE.DeviceDB.from_db(db, "cpu", **kw)
    assert td.tier == tier
    jga = JG.GenomeAnnotator(types.SimpleNamespace(ddb=jd))
    tga = TG.GenomeAnnotator(types.SimpleNamespace(ddb=td))
    dna = _synth(np.random.default_rng(9), db, 3 * JG.STEP)
    want, it_w, got, it_g, T = run_both(jga, tga, dna,
                                        EngineParams(min_hits=2))
    assert np.array_equal(got, want) and it_g == it_w
    assert int(got[:6 * T].sum()) > 0


def test_annotator_takes_the_engines_table_and_device(setup):
    db, _jga, _tga = setup
    eng = KmerEngine(db, "cpu")
    ga = TG.GenomeAnnotator(eng)
    assert ga.ddb is eng.fa.ddb and ga.device == torch.device("cpu")
    if not torch.cuda.is_available():   # the device defaults to "cuda"
        with pytest.raises(RuntimeError, match="cuda"):
            TG.GenomeAnnotator(db)
