"""Round checkpoints for the distributed peeling supervisor.

A peeling decomposition is a long sequence of bucket-range rounds; the
supervisor (``distributed.PeelSupervisor``) snapshots one
:class:`RoundCheckpoint` after every committed round so a lost device
never throws away the run — recovery restores the last snapshot,
re-partitions the plan over the surviving devices, and replays from
the round boundary. Because every engine is bitwise-deterministic, a
replay from any checkpoint converges on the same numbers as an
uninterrupted run.

Checkpoints are deliberately small and **JSON-serializable**: the plan
hash (so a snapshot can never resume a different plan), the round
cursor (round index / re-settle count / κ / active bucket bound), the
remaining-support array, the peel order so far (numbers + per-round
sizes), and a sha256 digest over the array payload. ``verify()``
recomputes the digest on restore — a truncated or hand-edited snapshot
surfaces as :class:`~repro_torch.core.resilience.CheckpointCorrupt`, never
as a silently wrong decomposition.

:class:`CheckpointStore` keeps the latest snapshot in memory and, when
given a directory, persists every round as
``checkpoint_round_<idx>.json`` — the cross-process resume path (a new
supervisor constructed over a non-empty store continues from its
latest snapshot instead of round 0).

This module is the reference package's, unchanged in every byte that
reaches a file: the schema string, the field set, the sorted-keys JSON
and the digest's byte layout. A checkpoint written by either package
loads and verifies in the other; whether it resumes a run depends only
on the plan hash (the port's peeling plans carry its own default
``tile_budget``, so a reference checkpoint resumes a port run given the
reference's ``tile_budget=1024`` and the same count dtype).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import List, Optional

import numpy as np

from .resilience import CheckpointCorrupt

__all__ = [
    "CHECKPOINT_SCHEMA",
    "RoundCheckpoint",
    "CheckpointStore",
    "plan_hash",
]

CHECKPOINT_SCHEMA = "repro.peel_checkpoint/v1"


def plan_hash(plan) -> str:
    """Stable identity of a plan: sha256 over its canonical JSON.
    Restoring under a different plan (different graph, knobs, or tile
    list) must be impossible — the digest is compared on restore."""
    return hashlib.sha256(plan.to_json().encode()).hexdigest()


def _array_digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class RoundCheckpoint:
    """One committed round boundary of a supervised peeling run."""

    schema: str
    plan_hash: str
    round_index: int  # committed bucket rounds
    sub_rounds: int  # committed re-settle iterations
    kappa: int
    bucket_hi: int  # exclusive upper bound of the last active bucket
    dtype: str  # numbers/support dtype name
    support: tuple  # remaining per-entity counts (full array)
    alive: tuple  # 0/1 per entity
    numbers: tuple  # peel numbers assigned so far
    round_sizes: tuple  # peel order so far: entities peeled per round
    digest: str  # sha256 over (support, alive, numbers)

    @classmethod
    def capture(
        cls,
        *,
        plan_hash: str,
        round_index: int,
        sub_rounds: int,
        kappa: int,
        bucket_hi: int,
        support: np.ndarray,
        alive: np.ndarray,
        numbers: np.ndarray,
        round_sizes,
    ) -> "RoundCheckpoint":
        support = np.asarray(support)
        alive = np.asarray(alive, dtype=bool)
        numbers = np.asarray(numbers)
        return cls(
            schema=CHECKPOINT_SCHEMA,
            plan_hash=str(plan_hash),
            round_index=int(round_index),
            sub_rounds=int(sub_rounds),
            kappa=int(kappa),
            bucket_hi=int(bucket_hi),
            dtype=support.dtype.name,
            support=tuple(int(x) for x in support),
            alive=tuple(int(x) for x in alive),
            numbers=tuple(int(x) for x in numbers),
            round_sizes=tuple(int(x) for x in round_sizes),
            digest=_array_digest(
                support, alive.astype(np.uint8), numbers
            ),
        )

    def arrays(self):
        """Decode the state arrays: ``(support, alive, numbers)``."""
        dt = np.dtype(self.dtype)
        return (
            np.asarray(self.support, dtype=dt),
            np.asarray(self.alive, dtype=np.uint8).astype(bool),
            np.asarray(self.numbers, dtype=dt),
        )

    def verify(self, plan_hash: Optional[str] = None) -> None:
        """Integrity + identity check; raises
        :class:`~repro_torch.core.resilience.CheckpointCorrupt`."""
        if self.schema != CHECKPOINT_SCHEMA:
            raise CheckpointCorrupt(
                f"checkpoint schema {self.schema!r} != {CHECKPOINT_SCHEMA!r}"
            )
        support, alive, numbers = self.arrays()
        got = _array_digest(support, alive.astype(np.uint8), numbers)
        if got != self.digest:
            raise CheckpointCorrupt(
                f"checkpoint round {self.round_index}: digest mismatch "
                f"(stored {self.digest[:12]}…, recomputed {got[:12]}…)"
            )
        if plan_hash is not None and plan_hash != self.plan_hash:
            raise CheckpointCorrupt(
                f"checkpoint round {self.round_index} belongs to plan "
                f"{self.plan_hash[:12]}…, not {plan_hash[:12]}…"
            )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RoundCheckpoint":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise CheckpointCorrupt(
                f"unknown checkpoint fields: {sorted(unknown)}"
            )
        kw = dict(d)
        for k in ("support", "alive", "numbers", "round_sizes"):
            kw[k] = tuple(int(x) for x in kw.get(k, ()))
        return cls(**kw)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "RoundCheckpoint":
        try:
            d = json.loads(s)
        except json.JSONDecodeError as e:
            raise CheckpointCorrupt(f"unparseable checkpoint: {e}") from e
        return cls.from_dict(d)


class CheckpointStore:
    """Latest-snapshot store with optional directory persistence.

    In-memory by default (recovery within one supervised run); with a
    ``directory`` every committed round is also written to
    ``checkpoint_round_<idx>.json`` and a fresh store constructed over
    the same directory reloads the latest snapshot — the cross-process
    resume path. ``restores`` counts how many times a supervisor
    rolled back to this store's snapshot (the recovery metric the
    per-run :class:`~repro_torch.core.resilience.ExecutionReport` records).

    ``retain_last=N`` bounds the directory: after each committed save
    only the newest N round files are kept (oldest pruned first, the
    just-written newest never pruned). Recovery only ever restores the
    *latest* snapshot, so pruning older rounds loses nothing a rollback
    could use; without it a ρ-round decomposition leaves ρ files behind
    (ρ is 10^2-10^5 on the paper's graphs — unbounded growth in a
    service that peels on every query). ``retain_last=None`` keeps the
    historical keep-everything behavior; ``retain_last >= 1``.
    """

    def __init__(self, directory: Optional[str] = None, *,
                 retain_last: Optional[int] = None):
        if retain_last is not None and int(retain_last) < 1:
            raise ValueError(
                f"retain_last must be None or >= 1, got {retain_last}"
            )
        self.directory = directory
        self.retain_last = None if retain_last is None else int(retain_last)
        self._latest: Optional[RoundCheckpoint] = None
        self.saved = 0
        self.restores = 0
        if directory:
            os.makedirs(directory, exist_ok=True)
            self._latest = self._load_latest_file()

    def _round_files(self) -> List[str]:
        names = [
            f for f in os.listdir(self.directory)
            if f.startswith("checkpoint_round_") and f.endswith(".json")
        ]
        return sorted(
            names, key=lambda f: int(f[len("checkpoint_round_"):-5])
        )

    def _load_latest_file(self) -> Optional[RoundCheckpoint]:
        files = self._round_files()
        if not files:
            return None
        path = os.path.join(self.directory, files[-1])
        with open(path) as fh:
            return RoundCheckpoint.from_json(fh.read())

    def save(self, cp: RoundCheckpoint) -> None:
        self._latest = cp
        self.saved += 1
        if self.directory:
            path = os.path.join(
                self.directory,
                f"checkpoint_round_{cp.round_index:06d}.json",
            )
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                fh.write(cp.to_json())
            os.replace(tmp, path)
            self._prune()

    def _prune(self) -> None:
        """Drop all but the newest ``retain_last`` round files. Runs
        after the atomic replace, so the newest snapshot is always on
        disk before anything is deleted; a prune interrupted mid-way
        leaves extra (older) files, never a missing latest."""
        if not self.directory or self.retain_last is None:
            return
        files = self._round_files()
        for name in files[:-self.retain_last]:
            try:
                os.remove(os.path.join(self.directory, name))
            except FileNotFoundError:
                pass  # a concurrent store pruned it first

    def latest(self) -> Optional[RoundCheckpoint]:
        return self._latest

    def restore(self, plan_hash: Optional[str] = None) -> RoundCheckpoint:
        """Fetch-and-verify the latest snapshot for a rollback."""
        if self._latest is None:
            raise CheckpointCorrupt("checkpoint store is empty")
        self._latest.verify(plan_hash)
        self.restores += 1
        return self._latest
