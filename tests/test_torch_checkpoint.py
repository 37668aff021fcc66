"""Round checkpoints of the port (``repro_torch.core.checkpoint``)
against the reference package's ``repro.core.checkpoint``.

The checkpoint file is a contract between the two packages: the same
schema string, field set, sorted-keys JSON and digest, so a round file
written by either loads and verifies in the other (tolerance 0: the
files are compared byte for byte). Whether a file resumes a run depends
only on the plan hash: the port's peeling plans carry its own default
``tile_budget`` (2^20 lanes; the reference's is 1024), so a reference
checkpoint is refused by a default port run and resumes one given
``tile_budget=1024`` and the same count dtype.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import jax  # noqa: E402,F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)

import repro.core as ref_core  # noqa: E402
from repro.core import checkpoint as ref_ckpt  # noqa: E402
from repro.core import peel as ref_peel  # noqa: E402
from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BipartiteGraph,
    CheckpointCorrupt,
    CheckpointStore,
    RoundCheckpoint,
    peel_tips,
)
from repro_torch.core import checkpoint as ckpt  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402


def rand_edges(nu, nv, m, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, nu, m), rng.integers(0, nv, m)], 1)


# the reference's distributed-peeling test graph
EDGES = rand_edges(40, 30, 300, 11)
GRAPH = BipartiteGraph(40, 30, EDGES)
REF_GRAPH = ref_core.BipartiteGraph(40, 30, EDGES)


def _capture(mod, ph="x" * 64, round_index=3):
    return mod.RoundCheckpoint.capture(
        plan_hash=ph,
        round_index=round_index,
        sub_rounds=7,
        kappa=5,
        bucket_hi=8,
        support=np.array([4, 0, 9], np.int64),
        alive=np.array([True, False, True]),
        numbers=np.array([0, 2, 0], np.int64),
        round_sizes=[1, 0, 1],
    )


@pytest.fixture(scope="module")
def tip_counts():
    """int64 per-U butterfly counts from the reference, so both packages
    peel the same array under the same plan dtype."""
    r = ref_core.count_butterflies(REF_GRAPH, mode="vertex")
    return np.asarray(r.per_u, np.int64)


def test_checkpoint_json_roundtrip_and_verify():
    cp = _capture(ckpt)
    again = RoundCheckpoint.from_json(cp.to_json())
    assert again == cp
    again.verify(plan_hash="x" * 64)
    s, a, n = again.arrays()
    assert s.dtype == np.int64 and np.array_equal(s, [4, 0, 9])
    assert a.dtype == bool and np.array_equal(a, [True, False, True])
    assert np.array_equal(n, [0, 2, 0])
    assert ckpt.CHECKPOINT_SCHEMA == ref_ckpt.CHECKPOINT_SCHEMA


def test_checkpoint_tamper_is_typed():
    cp = _capture(ckpt)
    d = cp.to_dict()
    d["support"] = [4, 1, 9]  # flip one count
    with pytest.raises(CheckpointCorrupt, match="digest mismatch"):
        RoundCheckpoint.from_dict(d).verify()
    with pytest.raises(CheckpointCorrupt, match="belongs to plan"):
        cp.verify(plan_hash="y" * 64)
    with pytest.raises(CheckpointCorrupt, match="unparseable"):
        RoundCheckpoint.from_json("{not json")
    with pytest.raises(CheckpointCorrupt, match="unknown checkpoint"):
        RoundCheckpoint.from_dict({**cp.to_dict(), "extra": 1})
    with pytest.raises(CheckpointCorrupt, match="schema"):
        RoundCheckpoint.from_dict({**cp.to_dict(), "schema": "v0"}).verify()


def test_checkpoint_store_persists_and_reloads(tmp_path):
    d = str(tmp_path / "ck")
    store = CheckpointStore(directory=d)
    store.save(_capture(ckpt))
    path = tmp_path / "ck" / "checkpoint_round_000003.json"
    assert path.exists()
    assert json.loads(path.read_text())["schema"] == ckpt.CHECKPOINT_SCHEMA
    fresh = CheckpointStore(directory=d)
    assert fresh.latest() == store.latest()
    assert fresh.restore() == store.latest() and fresh.restores == 1
    with pytest.raises(CheckpointCorrupt, match="empty"):
        CheckpointStore().restore()


def test_checkpoint_store_retain_last_bounds_directory(tmp_path):
    """retain_last=N keeps only the newest N round files; the newest is
    never pruned and still restores."""
    d = str(tmp_path / "bounded")
    store = CheckpointStore(directory=d, retain_last=2)
    for idx in (1, 2, 3, 4, 5):
        store.save(_capture(ckpt, round_index=idx))
        files = sorted(os.listdir(d))
        assert len(files) <= 2
        assert files[-1] == f"checkpoint_round_{idx:06d}.json"
    fresh = CheckpointStore(directory=d)
    assert fresh.latest().round_index == 5
    fresh.restore()
    with pytest.raises(ValueError, match="retain_last"):
        CheckpointStore(directory=d, retain_last=0)


def test_resume_rejects_other_plans_checkpoint():
    plan_a = pipeline.plan_peel(
        "peel_tips", expansion="peel_tips_2hop", engine="host",
        aggregation="sort", n_out=3,
    )
    store = CheckpointStore()
    store.save(_capture(ckpt, ph=ckpt.plan_hash(plan_a)))
    with pytest.raises(CheckpointCorrupt, match="belongs to plan"):
        store.restore("f" * 64)
    store.restore(ckpt.plan_hash(plan_a))


def test_plan_hash_matches_reference_for_the_same_plan():
    """Equal plans hash equal across the packages; the port's default
    tile budget makes a different plan."""
    kw = dict(expansion="peel_tips_2hop", engine="host", aggregation="sort",
              n_out=40, dtype="int64", entity_work=np.arange(40),
              capacity=(("max_frontier", 2**31 - 1), ("tile_budget", 1024)))
    ref_plan = ref_pipeline.plan_peel("peel_tips", **kw)
    assert ckpt.plan_hash(pipeline.plan_peel("peel_tips", **kw)) == \
        ref_ckpt.plan_hash(ref_plan)
    kw["capacity"] = (("max_frontier", 2**31 - 1), ("tile_budget", 1 << 20))
    assert ckpt.plan_hash(pipeline.plan_peel("peel_tips", **kw)) != \
        ref_ckpt.plan_hash(ref_plan)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_round_files_read_across_packages(tmp_path, writer):
    """A round file written by either package is byte-identical to the
    other's, and loads and verifies in the other."""
    mods = {"reference": ref_ckpt, "port": ckpt}
    reader = "port" if writer == "reference" else "reference"
    cp = _capture(mods[writer])
    assert cp.to_json() == _capture(mods[reader]).to_json()
    d = str(tmp_path / writer)
    mods[writer].CheckpointStore(directory=d).save(cp)
    back = mods[reader].CheckpointStore(directory=d).restore("x" * 64)
    assert back.to_json() == cp.to_json()
    s, a, n = back.arrays()
    assert np.array_equal(s, [4, 0, 9]) and np.array_equal(n, [0, 2, 0])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_peel_run_files_verify_in_the_other_package(tmp_path, writer,
                                                    tip_counts):
    """Every round file a supervised tip run leaves verifies in the other
    package, and both packages' runs write the same files (same plan,
    same state: the plan hashes agree under ``tile_budget=1024``)."""
    dirs = {w: str(tmp_path / w) for w in ("reference", "port")}
    ref_peel.peel_tips(REF_GRAPH, counts=tip_counts, side=0, devices=2,
                       checkpoint=dirs["reference"])
    peel_tips(GRAPH, counts=tip_counts, side=0, devices=2,
              checkpoint=dirs["port"], tile_budget=1024, device="cpu")
    files = sorted(os.listdir(dirs[writer]))
    assert files == sorted(os.listdir(dirs["reference" if writer == "port"
                                           else "port"]))
    reader = ckpt if writer == "reference" else ref_ckpt
    for f in files:
        with open(os.path.join(dirs[writer], f)) as fh:
            text = fh.read()
        with open(os.path.join(dirs["port"], f)) as fh:
            assert fh.read() == text
        reader.RoundCheckpoint.from_json(text).verify()


def _rewind(d, keep):
    """Drop all but the first ``keep`` round files: a mid-run store."""
    for f in sorted(os.listdir(d))[keep:]:
        os.remove(os.path.join(d, f))


def test_port_resumes_a_reference_run(tmp_path, tip_counts):
    """A port run over a reference run's rewound directory resumes it
    (``tile_budget=1024``, the same int64 counts) and ends on the
    reference's numbers and round data."""
    d = str(tmp_path / "ref_run")
    want = ref_peel.peel_tips(REF_GRAPH, counts=tip_counts, side=0,
                              devices=2, checkpoint=d)
    _rewind(d, 3)
    got = peel_tips(GRAPH, counts=tip_counts, side=0, devices=2,
                    checkpoint=d, tile_budget=1024, device="cpu")
    assert got.report.final_rung == "distributed"
    assert got.report.resumed_from_round == 2
    assert "resumed=2" in got.report.summary()
    assert np.array_equal(got.numbers, np.asarray(want.numbers))
    assert got.rounds == want.rounds and got.sub_rounds == want.sub_rounds
    assert np.array_equal(got.round_sizes, np.asarray(want.round_sizes))


def test_reference_resumes_a_port_run(tmp_path, tip_counts):
    d = str(tmp_path / "port_run")
    want = peel_tips(GRAPH, counts=tip_counts, side=0, devices=2,
                     checkpoint=d, tile_budget=1024, device="cpu")
    _rewind(d, 3)
    got = ref_peel.peel_tips(REF_GRAPH, counts=tip_counts, side=0,
                             devices=2, checkpoint=d)
    assert got.report.final_rung == "distributed"
    assert np.array_equal(np.asarray(got.numbers), want.numbers)
    assert got.rounds == want.rounds


def test_default_port_run_refuses_a_reference_checkpoint(tmp_path,
                                                         tip_counts):
    """Under the port's default tile budget the plan differs, so the
    reference's snapshot is refused as another plan's: the distributed
    rung reports ``checkpoint-corrupt`` and the ladder descends to the
    host rung, which ends on the same numbers."""
    d = str(tmp_path / "ref_run")
    want = ref_peel.peel_tips(REF_GRAPH, counts=tip_counts, side=0,
                              devices=2, checkpoint=d)
    _rewind(d, 3)
    got = peel_tips(GRAPH, counts=tip_counts, side=0, devices=2,
                    checkpoint=d, device="cpu")
    assert got.report.attempts[0].outcome == "checkpoint-corrupt"
    assert "belongs to plan" in got.report.attempts[0].detail
    assert got.report.final_rung == "host"
    assert np.array_equal(got.numbers, np.asarray(want.numbers))
