"""Versioned result cache with a stale-result side store.

Exact entries are keyed ``(graph_version, query_key)`` where the
version is the graph's content hash
(:meth:`~repro_torch.core.graph.BipartiteGraph.content_hash`): a repeat
query against unchanged data is an O(1) dictionary hit, and
re-registering a graph under the same name with *different* content
simply orphans the old version's keys (``invalidate_version`` drops
them eagerly so memory follows the resident set).

The stale store is the deadline ladder's bottom rung: keyed by the
*registration name* ``(graph_key, query_key)``, it remembers the last
good result per query shape across version changes. A query whose
budget ran out before any live rung could finish may (``allow_stale``)
take the stale answer — explicitly marked with the version it was
computed against, never silently passed off as current.

Results stored here are immutable by convention (CountResult /
PeelResult / ApproxCount namedtuples over host numpy arrays the engines
never mutate), so cache hits can share references without cross-query
poisoning; the concurrency stress suite asserts exactly that. They hold
no ``torch.Tensor``, so a long-lived service pins no device memory
through its cache.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

__all__ = ["ResultCache"]


class ResultCache:
    """Thread-safe exact + stale result store for one service."""

    def __init__(self):
        self._lock = threading.Lock()
        self._exact: Dict[Tuple[str, Any], Any] = {}
        self._stale: Dict[Tuple[str, Any], Tuple[str, Any]] = {}
        self.hits = 0
        self.misses = 0
        self.stale_hits = 0

    def get(self, version: str, qkey) -> Optional[Any]:
        with self._lock:
            out = self._exact.get((version, qkey))
            if out is None:
                self.misses += 1
            else:
                self.hits += 1
            return out

    def put(self, version: str, graph_key: str, qkey, result) -> None:
        with self._lock:
            self._exact[(version, qkey)] = result
            self._stale[(graph_key, qkey)] = (version, result)

    def stale_get(self, graph_key: str, qkey) -> Optional[Tuple[str, Any]]:
        """Last good ``(version, result)`` for this query shape under
        this registration name, surviving re-registration."""
        with self._lock:
            out = self._stale.get((graph_key, qkey))
            if out is not None:
                self.stale_hits += 1
            return out

    def invalidate_version(self, version: str) -> int:
        """Drop every exact entry computed against ``version`` (called
        when a registration name moves to new content). Stale entries
        stay — they are the explicitly-marked fallback tier."""
        with self._lock:
            dead = [k for k in self._exact if k[0] == version]
            for k in dead:
                del self._exact[k]
            return len(dead)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._exact),
                "stale_entries": len(self._stale),
                "hits": self.hits,
                "misses": self.misses,
                "stale_hits": self.stale_hits,
            }
