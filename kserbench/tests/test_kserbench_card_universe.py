"""The family universe made by torch on the run's device
(``gen.card_mapping``) equals the frozen numpy ``gen.scale_mapping``
array for array and string for string, over one block and over many; the
harness makes every family universe with it (the tiny family cell's end
to end runs, its faults and its control are in ``test_kserbench_cell``
and ``test_kserbench_faults``); and the cell ``family-genomes-971m`` is
found from ``BENCHMARK.json``."""

import numpy as np
import pytest
import torch

CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=[
    (300_000, True, 50, 5), (50_000, False, 40, 77), (50_000, True, 40, 77)],
    ids=["tiny", "uniform", "biased"])
def db(request):
    from kserbench.gen.scale_db import scale_db
    return scale_db(*request.param, CPU).freeze()


def assert_same_universe(got, want):
    assert got.keys is want.keys
    for name in ("offs", "vals"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    for name in ("pgf", "plf", "genus_id", "function"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("n_blocks", [1, 3, 7])
def test_card_mapping_equals_the_frozen_builder(db, n_blocks):
    """One block (the builder's own size), three equal blocks, and seven
    with a short last one."""
    from kserbench.gen.card_mapping import CARD_BLOCK, card_mapping
    from kserbench.gen.scale_mapping import scale_mapping
    block = CARD_BLOCK if n_blocks == 1 else -(-len(db) // n_blocks)
    assert -(-len(db) // block) == n_blocks
    want = scale_mapping(db.keys, db.fi, db.functions)
    got = card_mapping(db.keys, db.fi, db.functions, CPU, block)
    assert_same_universe(got, want)
    # the DB's arrays are read, never written
    assert not db.keys.flags.writeable and not db.fi.flags.writeable


def test_card_mapping_of_no_keys():
    from kserbench.gen.card_mapping import card_mapping
    keys = np.zeros(0, np.int64)
    u = card_mapping(keys, np.zeros(0, np.int32), ["f0"], CPU)
    assert u.offs.tolist() == [0] and len(u.vals) == 0
    assert u.pgf == ["PGF_00000000", "PGF_00000001", "PGF_00000002"]


def test_universe_of_a_family_configuration_is_the_card_builders(db):
    """The harness makes every family universe with the card builder,
    equal to the frozen one and read-only; a query configuration has
    none."""
    from kserbench.harness.cell import universe_of
    from kserbench.gen.scale_mapping import scale_mapping
    u = universe_of({"family_mode": True}, db, CPU)
    assert_same_universe(u, scale_mapping(db.keys, db.fi, db.functions))
    assert not u.offs.flags.writeable and not u.vals.flags.writeable
    assert universe_of({"family_mode": False}, db, CPU) is None


def test_family_genomes_971m_is_found_from_the_benchmark():
    from kserbench.harness.spec import Spec
    s = Spec()
    cell = s.cell("family-genomes-971m")
    assert cell["chips"] == 1 and cell["traffic"] == "genomes"
    entry = next(c for c in s.data["configs"]
                 if c["name"] == cell["config"])
    assert entry["file"] == "kserbench/configs/kser_family_aa971m.json"
    config = s.config(cell)
    assert config["name"] == "kser_family_aa971m"
    assert config["family_mode"] is True
    assert config["n_keys"] == 970_978_247
    assert config["reduced"] == entry["reduced"] == ["n_functions"]
    assert s.traffic(cell)["clients"] == 12
    assert s.endpoint(config["endpoint"]).PATH
    assert [m["name"] for m in s.metrics(cell["name"], False)] == [
        "device_peak_gib", "setup_s"]
    traced = [m["name"] for m in s.metrics(cell["name"], True)]
    assert traced == [m["name"] for m in s.metrics("family-genomes", True)]
    assert traced == [
        "proteins_per_s.family",
        "server_self_ms_per_kprot.family", "engine_ms_per_kprot.family",
        "host_score_ms_per_kprot.family",
        "device_program_ms_per_kprot.family", "window_fill_pct.family",
        "probe_search_roofline.family", "family_group_roofline.genomes",
        "device_idle_pct.family"]
    for name in traced:
        assert callable(s.reader(name)), name
        assert next(m for m in s.data["per_layer"] if m["name"] == name)[
            "moves"] == "device_peak_gib", name
