"""Pools load against their digests, and the generator gives every seed
the same requests in balanced rounds."""

import collections
import itertools
import os
import shutil

import numpy as np
import pytest

import portbench_support as sup
from portbench.harness.pool import digest, load_pool
from portbench.harness.registry import load_cell
from portbench.harness.traffic import request_table, requests

CELL = "svpchal80-bkz2.b60-windows"


def test_committed_pool_matches_its_digests_and_table():
    cell = load_cell(sup.bench_json(), CELL)
    assert cell.pool["bases"].shape == (8 * 21, 80, 80)
    assert len(cell.table) == 8 * 21
    assert {r["kappa"] for r in cell.table} == set(range(21))
    assert sorted(r["basis"] for r in cell.table) == list(range(8 * 21))
    assert all(r["radius"] > 0 for r in cell.table)
    sets = len(cell.config["pruning"]["sets"])
    assert all(0 <= r["prune"] < sets for r in cell.table)


def test_a_changed_array_is_refused(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    for ext in ("npz", "json"):
        shutil.copy(os.path.join(sup.BENCH_DIR, "data", f"svpchal80-bkz2.{ext}"),
                    data)
    load_pool(str(tmp_path), "svpchal80-bkz2.npz")
    with np.load(data / "svpchal80-bkz2.npz") as z:
        arrays = {k: z[k] for k in z.files}
    arrays["win_radius"] = arrays["win_radius"] * (1 + 1e-12)
    np.savez_compressed(data / "svpchal80-bkz2.npz", **arrays)
    with pytest.raises(ValueError, match="win_radius"):
        load_pool(str(tmp_path), "svpchal80-bkz2.npz")


def test_digest_sees_dtype_shape_and_bytes():
    a = np.arange(6, dtype=np.int64)
    assert digest(a) != digest(a.reshape(2, 3))
    assert digest(a) != digest(a.astype(np.int32))
    assert digest(a) == digest(a.copy())


def test_every_seed_runs_the_same_requests_in_balanced_rounds():
    cell = load_cell(sup.bench_json(), CELL)
    table, traffic = cell.table, cell.traffic
    n = len(table)
    firsts = []
    for seed in (0, 7, 2 ** 31 + 5, 98765432109):
        seq = list(itertools.islice(requests(table, traffic, seed), 2 * n))
        for cycle in (seq[:n], seq[n:]):
            assert sorted(cycle) == list(range(n))
        for t in range(2 * n // 21):
            rnd = seq[21 * t:21 * (t + 1)]
            assert sorted(table[i]["kappa"] for i in rnd) == list(range(21))
            per_lattice = collections.Counter(table[i]["lattice"]
                                              for i in rnd)
            assert max(per_lattice.values()) - min(per_lattice.values()) <= 1
        firsts.append(seq[:n])
    assert len({tuple(f) for f in firsts}) == len(firsts)
    again = list(itertools.islice(requests(table, traffic, 7), n))
    assert again == firsts[1]


def test_table_must_be_a_cross_product():
    pool = {"win_basis": np.array([0, 0, 1]), "win_kappa": np.array([0, 1, 0])}
    table = request_table(pool, {"table": "win"})
    with pytest.raises(ValueError, match="cross product"):
        next(requests(table, {"rounds_over": "kappa",
                              "spread_over": "basis"}, 1))
