"""Port parity: the scoring state machine (close_kmers_tpu_torch.ops.
scan_score, plain torch version on the CPU) against the Pallas kernel
scan_score_pallas in interpret mode and against the XLA scan
(_scan_score / _scan_score_core).  Integer fields compare exactly and
f32 weights via their int32 bits: the tolerance is zero."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from close_kmers_tpu.core.device_score import _scan_score, _scan_score_core
from close_kmers_tpu.ops.pallas_scan import TB, scan_score_pallas
from close_kmers_tpu_torch.ops.scan_score import (FLOAT_FIELDS, INT_FIELDS,
                                                  scan_score)

PARAMS = [
    dict(min_hits=5, min_weighted_hits=0, max_gap=200, order_constraint=0),
    dict(min_hits=2, min_weighted_hits=0, max_gap=10, order_constraint=0),
    dict(min_hits=1, min_weighted_hits=2, max_gap=50, order_constraint=0),
    dict(min_hits=2, min_weighted_hits=0, max_gap=200, order_constraint=1),
]


def random_streams(rng, B, W, n_funcs=5, p_hit=0.3):
    found = rng.random((B, W)) < p_hit
    fi = rng.integers(0, n_funcs, size=(B, W)).astype(np.int32)
    av = rng.integers(0, 300, size=(B, W)).astype(np.int32)
    wt = rng.uniform(0.1, 3.0, size=(B, W)).astype(np.float32)
    return found, fi, av, wt


def port_scan(streams, params, **kw):
    t = [torch.from_numpy(x) for x in streams]
    return scan_score(*t, params["min_hits"], params["min_weighted_hits"],
                      params["max_gap"], params["order_constraint"], **kw)


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_emitted_equal(emit_w, fields_w, emit_g, fields_g):
    emit_w = np.asarray(emit_w)
    assert np.array_equal(emit_w, emit_g.numpy())
    for fw, fg in zip(fields_w, fields_g):
        assert np.array_equal(bits(fw)[emit_w], bits(fg.numpy())[emit_w])


@pytest.mark.parametrize("params", PARAMS)
def test_scan_matches_pallas_and_xla(params):
    rng = np.random.default_rng(8)
    streams = random_streams(rng, TB, 96)
    j = [jnp.asarray(x) for x in streams]
    emit_x, fields_x = _scan_score(*j, **params)
    emit_p, fields_p = scan_score_pallas(*j, interpret=True, **params)
    emit_g, fields_g, _ = port_scan(streams, params)
    assert np.asarray(emit_x).sum() > 0
    assert_emitted_equal(emit_x, fields_x, emit_g, fields_g)
    assert_emitted_equal(emit_p, fields_p, emit_g, fields_g)


def test_scan_dense_runs():
    rng = np.random.default_rng(9)
    B, W = TB, 64
    streams = (np.ones((B, W), bool),
               rng.integers(0, 2, size=(B, W)).astype(np.int32),
               np.zeros((B, W), np.int32), np.ones((B, W), np.float32))
    params = dict(min_hits=3, min_weighted_hits=0, max_gap=200,
                  order_constraint=0)
    j = [jnp.asarray(x) for x in streams]
    emit_x, fields_x = _scan_score(*j, **params)
    emit_p, fields_p = scan_score_pallas(*j, interpret=True, **params)
    emit_g, fields_g, _ = port_scan(streams, params)
    assert_emitted_equal(emit_x, fields_x, emit_g, fields_g)
    assert_emitted_equal(emit_p, fields_p, emit_g, fields_g)


@pytest.mark.parametrize("params", [PARAMS[1], PARAMS[3]])
def test_scan_chained_tile_matches_core(params):
    """A second tile resumed from the first tile's carry, with per-row
    pos0 and final_flush, against _scan_score_core: every output plane
    and the final 13-field state, bit for bit."""
    rng = np.random.default_rng(10)
    B, W = 40, 48                   # no multiple of any tile size
    first = random_streams(rng, B, W)
    second = random_streams(rng, B, W)
    _, _, carry = _scan_score_core(*(jnp.asarray(x) for x in first),
                                   want_emit=False, **params)
    pos0 = rng.integers(0, 400, size=B).astype(np.int32)
    flush = rng.random(B) < 0.5
    emit_w, fields_w, state_w = _scan_score_core(
        *(jnp.asarray(x) for x in second), init=carry,
        pos0=jnp.asarray(pos0), final_flush=jnp.asarray(flush), **params)
    init = {k: torch.from_numpy(np.array(v)) for k, v in carry.items()}
    emit_g, fields_g, state_g = port_scan(
        second, params, init=init, pos0=torch.from_numpy(pos0),
        final_flush=torch.from_numpy(flush))
    assert np.asarray(emit_w).sum() > 0
    assert np.array_equal(np.asarray(emit_w), emit_g.numpy())
    for fw, fg in zip(fields_w, fields_g):
        assert np.array_equal(bits(fw), bits(fg.numpy()))
    for k in INT_FIELDS + FLOAT_FIELDS:
        assert np.array_equal(bits(state_w[k]), bits(state_g[k].numpy())), k


def test_scan_want_emit_false_returns_state_only():
    rng = np.random.default_rng(11)
    streams = random_streams(rng, 24, 40)
    _, _, state_w = _scan_score_core(*(jnp.asarray(x) for x in streams),
                                     want_emit=False, **PARAMS[0])
    emit, fields, state_g = port_scan(streams, PARAMS[0], want_emit=False)
    assert emit is None and fields is None
    for k in INT_FIELDS + FLOAT_FIELDS:
        assert np.array_equal(bits(state_w[k]), bits(state_g[k].numpy())), k


def test_scan_cpu_takes_the_plain_version():
    rng = np.random.default_rng(12)
    before = scan_score.launches
    port_scan(random_streams(rng, 3, 20), PARAMS[0])
    assert scan_score.launches == before


@pytest.mark.parametrize("which,bad", [
    (0, np.zeros((4, 16), np.int32)),     # found must be bool
    (1, np.zeros((4, 16), np.int64)),     # fi must be int32
    (3, np.zeros((4, 16), np.float64)),   # wt must be float32
    (2, np.zeros((4, 15), np.int32)),     # shapes must agree
])
def test_scan_rejects_bad_inputs(which, bad):
    streams = list(random_streams(np.random.default_rng(0), 4, 16))
    streams[which] = bad
    with pytest.raises((TypeError, ValueError)):
        port_scan(streams, PARAMS[0])
