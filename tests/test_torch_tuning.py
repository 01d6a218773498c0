"""The port's dispatch-table core (raft_tpu_torch.tuning) against the JAX
reference's (raft_tpu.tuning): the key distance, a table's lookup and
lookup_entry, and choose in "off" and "table" modes, on the reference's
own packaged cpu.json (the port ships a copy) and on hand-made tables
loaded by both packages; a table saved by either package loads in the
other. Each test restores both packages' mode and table path.
"""

import json
import math
import os

import pytest

from raft_tpu import tuning as jax_tuning
from raft_tpu.tuning import table as jax_table
from raft_tpu_torch import tuning
from raft_tpu_torch.tuning import table


@pytest.fixture(autouse=True)
def restore():
    yield
    for mod in (tuning, jax_tuning):
        mod.set_table_path(None)
        mod.set_mode(None)
        mod.reload()


def test_packaged_cpu_table_is_the_reference_s():
    with open(os.path.join(jax_tuning.tables_dir(), "cpu.json")) as f:
        ref = json.load(f)
    with open(os.path.join(tuning.tables_dir(), "cpu.json")) as f:
        assert json.load(f) == ref
    assert tuning.table_path("cpu").endswith(
        os.path.join("raft_tpu_torch", "tuning", "tables", "cpu.json"))
    # no table has been captured on the card: a CUDA call finds none
    assert tuning.backend_name("cuda") == "cuda"
    assert tuning.backend_name("cpu") == tuning.backend_name(None) == "cpu"
    assert tuning.table_path("cuda") is None
    assert tuning.get_table("cuda") is None


_KEYS = [
    ({"n": 8192, "k": 64}, {"n": 8192, "k": 64}),
    ({"n": 8192, "k": 64}, {"n": 65536, "k": 16}),
    ({"n": 8192, "k": 64, "dtype": "float32"},
     {"n": 4096, "k": 64, "dtype": "float32"}),
    ({"n": 8192, "dtype": "float32"}, {"n": 8192, "dtype": "bfloat16"}),
    ({"approx": True, "cap": 512}, {"approx": False, "cap": 512}),
    ({"approx": True, "cap": 512}, {"approx": True, "cap": 4096}),
    ({"approx": True}, {"approx": True, "cap": 512}),
    ({"dtype": "float32"}, {"dtype": "float32"}),
    ({"n": 10}, {"m": 10}),                        # disjoint keys: a miss
    ({}, {"n": 10}),
    ({"n": 0, "k": 1}, {"n": 1e-40, "k": 1}),
    ({"k": 3}, {"k": 3.0, "extra": "x"}),
    ({"flag": 1}, {"flag": True}),
]


@pytest.mark.parametrize("query, key", _KEYS, ids=range(len(_KEYS)))
def test_key_distance_matches_reference(query, key):
    want = jax_table._key_distance(query, key)
    got = table._key_distance(query, key)
    assert (got is None) == (want is None)
    if want is not None:
        assert math.isclose(got, want, rel_tol=0, abs_tol=0)


def _hand_table():
    return {
        "version": 1, "backend": "cpu", "ops": {
            "ivf_scan_extract": {"entries": [
                {"key": {"cap": 512, "k": 10, "g": 256}, "winner": "fold",
                 "times_ms": {"fold": 1.0, "binned": 2.0}},
                {"key": {"cap": 4096, "k": 64, "g": 128},
                 "winner": "binned_deep", "times_ms": {"binned_deep": 3.0}},
                {"key": {"cap": 512, "k": 200, "g": 256}, "winner": "exact",
                 "times_ms": {"exact": 1.0}}]},
            "ivf_scan": {"entries": [
                {"key": {"approx": True, "cap": 512, "k": 10},
                 "winner": "pallas", "times_ms": {}},
                {"key": {"approx": False, "cap": 512, "k": 10},
                 "winner": "xla", "times_ms": {}}]},
            "select_k": {"entries": [
                {"key": {"n": 8192, "k": 64, "dtype": "float32"},
                 "winner": "tournament", "times_ms": {}},
                {"key": {"n": 8192, "k": 64, "dtype": "int32"},
                 "winner": "top_k", "times_ms": {}}]}},
        "budgets": {"cagra_inline_bytes": 123}}


_LOOKUPS = [
    ("ivf_scan_extract", {"cap": 512, "k": 10, "g": 256}, None),
    ("ivf_scan_extract", {"cap": 512, "k": 10, "g": 256},
     ["exact", "binned", "binned_deep"]),      # winner not a candidate
    ("ivf_scan_extract", {"cap": 640, "k": 12, "g": 200}, None),
    ("ivf_scan_extract", {"cap": 512, "k": 150, "g": 256}, None),
    ("ivf_scan_extract", {"cap": 65536, "k": 10, "g": 256}, None),  # far
    ("ivf_scan_extract", {"cap": 2048, "k": 40, "g": 128}, None),
    ("ivf_scan", {"approx": True, "cap": 1024, "k": 10}, None),
    ("ivf_scan", {"approx": False, "cap": 1024, "k": 10}, ["xla"]),
    ("select_k", {"n": 9000, "k": 60, "dtype": "float32"}, None),
    ("select_k", {"n": 9000, "k": 60, "dtype": "bfloat16"}, None),
    ("select_k", {"batch": 64}, None),                 # disjoint
    ("nothing", {"n": 1}, None),
]


@pytest.mark.parametrize("op, key, candidates", _LOOKUPS,
                         ids=range(len(_LOOKUPS)))
def test_lookup_matches_reference_on_a_hand_made_table(op, key, candidates):
    ref = jax_table.DispatchTable(_hand_table())
    got = table.DispatchTable(_hand_table())
    assert got.lookup(op, key, candidates) == ref.lookup(op, key,
                                                         candidates)
    assert got.lookup_entry(op, key) == ref.lookup_entry(op, key)
    for r in (0.5, 1.0, 4.0):
        assert got.lookup(op, key, candidates, max_l2=r) == \
            ref.lookup(op, key, candidates, max_l2=r)
        assert got.lookup_entry(op, key, max_l2=r) == \
            ref.lookup_entry(op, key, max_l2=r)


def test_lookup_matches_reference_on_the_cpu_table():
    ref = jax_tuning.get_table()
    got = tuning.get_table("cpu")
    assert got.ops() == ref.ops()
    assert got.n_entries() == ref.n_entries()
    assert got.budget("cagra_inline_bytes") == ref.budget(
        "cagra_inline_bytes")
    assert got.budget("missing") is ref.budget("missing") is None
    n = 0
    for op in ref.ops():
        assert got.n_entries(op) == ref.n_entries(op)
        for e in ref.data["ops"][op]["entries"]:
            for scale in (1.0, 1.7, 6.0, 40.0):
                key = {f: (v * scale if isinstance(v, (int, float)) and
                           not isinstance(v, bool) else v)
                       for f, v in e["key"].items()}
                for cands in (None, [e["winner"]], ["nobody"]):
                    assert got.lookup(op, key, cands) == ref.lookup(
                        op, key, cands)
                assert got.lookup_entry(op, key) == ref.lookup_entry(op,
                                                                     key)
                n += 1
    assert n > 100


def _choices():
    return [
        ("select_k", {"batch": 64, "dtype": "float32", "k": 64,
                      "n": 8192}, ["top_k", "tournament"], "tournament"),
        ("select_k", {"batch": 64, "dtype": "float32", "k": 64,
                      "n": 8192}, ["tournament"], "tournament"),
        ("merge_topk", {"batch": 256, "dtype": "float32", "k": 10,
                        "n": 1280}, ["top_k", "hierarchical"], "x"),
        ("fused_topk_tile", {"m": 512, "n": 20000, "d": 64, "k": 10},
         ["scan", "fused_exact:512"], "fused_exact:512"),
        ("ivf_scan_extract", {"cap": 512, "k": 10, "g": 256},
         ["exact", "binned", "binned_deep", "fold"], "binned"),
        ("ivf_scan_extract", {"cap": 512, "k": 10, "g": 256},
         ["exact"], "exact"),
        ("ivf_scan", {"approx": True, "cap": 512, "k": 10},
         ["xla", "pallas"], "pallas"),
        ("pq_scan", {"cap": 512, "k": 10}, [], "i8"),
        ("unknown_op", {"n": 3}, ["a", "b"], "b"),
    ]


@pytest.mark.parametrize("mode", ["off", "table"])
def test_choose_matches_reference_on_the_cpu_table(mode):
    tuning.set_mode(mode)
    jax_tuning.set_mode(mode)
    for op, key, cands, fallback in _choices():
        assert tuning.choose(op, key, cands, fallback, device="cpu") == \
            jax_tuning.choose(op, key, cands, fallback), (op, key)


@pytest.mark.parametrize("mode", ["off", "table", "measure"])
def test_choose_matches_reference_on_a_hand_made_table(mode, tmp_path):
    path = str(tmp_path / "hand.json")
    table.DispatchTable(_hand_table()).save(path)
    for mod in (tuning, jax_tuning):
        mod.set_table_path(path)
        mod.set_mode(mode)
    for op, key, cands, fallback in _choices():
        if mode == "measure" and op in tuning.MEASURABLE_INLINE:
            continue
        # the table path overrides the backend's table on either device
        for dev in ("cpu", "cuda"):
            assert tuning.choose(op, key, cands, fallback, device=dev) == \
                jax_tuning.choose(op, key, cands, fallback), (op, key)
    want_fold = "off" if mode == "off" else "table"
    got = tuning.choose("ivf_scan_extract", {"cap": 600, "k": 11, "g": 256},
                        ["exact", "binned", "binned_deep", "fold"], "binned")
    assert got == ("binned" if want_fold == "off" else "fold")


def test_measure_mode_is_not_ported(tmp_path):
    tuning.set_mode("measure")
    tuning.set_table_path(str(tmp_path / "none.json"))    # no table: a miss
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        tuning.choose("select_k", {"n": 10, "k": 1}, ["top_k", "x"],
                      "top_k")
    # one candidate, or an op the reference does not measure: the fallback
    assert tuning.choose("select_k", {"n": 10}, ["top_k"], "top_k") == \
        "top_k"
    assert tuning.choose("ivf_scan_extract", {"k": 1}, ["exact", "fold"],
                         "exact") == "exact"


def test_modes_and_paths():
    assert tuning.mode() == jax_tuning.mode()
    for m in ("off", "table", "measure"):
        tuning.set_mode(m)
        assert tuning.mode() == m
    with pytest.raises(ValueError, match="mode must be"):
        tuning.set_mode("fast")
    tuning.set_mode(None)
    assert tuning.mode() == jax_tuning.mode()
    tuning.set_table_path("/nonexistent/table.json")
    assert tuning.table_path("cpu") == "/nonexistent/table.json"
    assert tuning.get_table("cpu") is None          # unreadable: no table
    assert tuning.choose("select_k", {"n": 8192}, ["top_k"], "fb") == "fb"
    assert tuning.fused_topk_candidate_impls(42, True) == \
        jax_tuning.fused_topk_candidate_impls(42, True)
    for k in (1, 128, 129, 256, 257):
        for approx in (False, True):
            assert tuning.fused_topk_candidate_impls(k, approx) == \
                jax_tuning.fused_topk_candidate_impls(k, approx)
    assert tuning.FUSED_TOPK_TILES == jax_tuning.FUSED_TOPK_TILES
    assert tuning.FUSED_TOPK_TILE_FLOOR == jax_tuning.FUSED_TOPK_TILE_FLOOR


def test_save_load_round_trip_across_packages(tmp_path):
    t = table.DispatchTable()
    assert t.record("select_k", {"n": 10, "k": 2},
                    {"a": 2.0, "b": 1.0, "c": float("inf")}) == "b"
    assert t.record("select_k", {"n": 10, "k": 2}, {"a": 0.5}) == "a"
    t.record("ivf_scan_extract", {"cap": 512, "k": 10, "g": 256},
             {"fold": 1.23456789, "binned": None, "exact": 9.0})
    t.set_budget("cagra_inline_bytes", 77)
    with pytest.raises(ValueError, match="no finite timing"):
        t.record("x", {}, {"a": float("nan")})
    path = str(tmp_path / "sub" / "t.json")
    t.save(path)
    back = table.DispatchTable.load(path)
    assert back.data == t.data
    assert back.n_entries() == 2 and back.n_entries("select_k") == 1
    assert back.lookup("ivf_scan_extract",
                       {"cap": 512, "k": 10, "g": 256}) == "fold"
    ref = jax_table.DispatchTable.load(path)
    assert ref.data == back.data
    path2 = str(tmp_path / "ref.json")
    ref.save(path2)
    with open(path) as a, open(path2) as b:
        assert a.read() == b.read()
    bad = tmp_path / "v2.json"
    bad.write_text(json.dumps({"version": 2, "ops": {}}))
    with pytest.raises(ValueError, match="version"):
        table.DispatchTable.load(str(bad))
