"""Batch-parallel Fibonacci heap (paper §5): host reference.

The paper's theory section contributes a Fibonacci heap with
batch-insert (O(k) amortized), parallel delete-min (O(log n) amortized)
and batch-decrease-key (O(k) amortized), used to make peeling
work-efficient. Pointer-chasing heaps do not map onto a GPU's wide
parallel passes, so the device peeler uses dense bucketing (the
``bucket_min`` and ``bucket_update`` kernels); this module keeps a
faithful pure-Python implementation with the paper's *semantics*
(integer mark counters, round-based consolidation, propagation-path
marking) as the reference bucketing structure for tests and the
documentation of the theory artifact. It is the reference package's
``core/fibheap.py``, copied so the port imports nothing of it.

Nodes are keyed by int; values are opaque python objects (the bucketing
use stores sets of vertex/edge ids per key, §5.4).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["FibHeap", "BucketStructure"]


class _Node:
    __slots__ = ("key", "value", "parent", "children", "marks", "rank")

    def __init__(self, key: int, value: Any):
        self.key = key
        self.value = value
        self.parent: Optional[_Node] = None
        self.children: List[_Node] = []
        self.marks = 0  # integer marks (paper §5: counts, not booleans)
        self.rank = 0


class FibHeap:
    """Fibonacci heap with the paper's batch operations."""

    def __init__(self):
        self._roots: Dict[int, _Node] = {}  # root-list as hash table (§5)
        self._nodes: Dict[int, _Node] = {}  # key -> node (keys unique here)
        self._min_key: Optional[int] = None

    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, key: int) -> bool:
        return key in self._nodes

    def _update_min(self):
        # prefix-sum over roots in the paper; host reference uses min().
        self._min_key = min(self._roots) if self._roots else None

    def batch_insert(self, items: Iterable[Tuple[int, Any]]):
        """O(k) amortized: add singletons to the root list (Lemma 5.1)."""
        for key, value in items:
            if key in self._nodes:
                raise KeyError(f"duplicate key {key}")
            node = _Node(key, value)
            self._nodes[key] = node
            self._add_root(node)
        self._update_min()

    def _add_root(self, node: _Node):
        node.parent = None
        # Root list stores one tree per key here; same-key roots merge
        # eagerly (keeps the bucketing invariant of one bucket per key).
        cur = self._roots.get(node.key)
        if cur is None:
            self._roots[node.key] = node
        else:
            # merge: same key, attach arbitrary (heap order holds: equal)
            cur.children.append(node)
            node.parent = cur
            cur.rank = max(cur.rank, len(cur.children))

    def find_min(self) -> Optional[int]:
        return self._min_key

    def delete_min(self) -> Tuple[int, Any]:
        """Parallel delete-min (Alg. 9): pop min, promote children,
        consolidate trees by rank in O(log n) rounds."""
        if self._min_key is None:
            raise IndexError("empty heap")
        key = self._min_key
        node = self._roots.pop(key)
        del self._nodes[key]
        for ch in node.children:
            ch.parent = None
            self._consolidate_in(ch)
        self._update_min()
        return key, node.value

    def _consolidate_in(self, node: _Node):
        # Group roots by rank; merge pairs until ranks unique (Alg. 9
        # lines 4-10). Host reference merges incrementally.
        cur = self._roots.get(node.key)
        if cur is None:
            self._roots[node.key] = node
            return
        if cur.key <= node.key:
            cur.children.append(node)
            node.parent = cur
            cur.rank += 1
        else:
            node.children.append(cur)
            cur.parent = node
            node.rank += 1
            self._roots[node.key] = node

    def batch_decrease_key(self, changes: Iterable[Tuple[int, int]]):
        """BATCH-DECREASE-KEY (Alg. 10): cut violating nodes, add integer
        marks to parents, cascade cuts for parents with > 1 mark."""
        marked: List[_Node] = []
        for old_key, new_key in changes:
            node = self._nodes.get(old_key)
            if node is None:
                raise KeyError(old_key)
            if new_key > old_key:
                raise ValueError("decrease-key must not increase")
            del self._nodes[old_key]
            if node.key in self._roots and self._roots[node.key] is node:
                del self._roots[node.key]
            parent = node.parent
            node.key = new_key
            self._nodes[new_key] = node
            if parent is not None:
                parent.children.remove(node)
                parent.rank = len(parent.children)
                self._add_root(node)
                parent.marks += 1
                marked.append(parent)
            else:
                self._add_root(node)
        # cascade: cut parents with > 1 mark (Alg. 10 lines 10-17)
        frontier = [p for p in marked if p.marks > 1 and p.parent is not None]
        while frontier:
            nxt: List[_Node] = []
            for p in frontier:
                gp = p.parent
                if gp is None or p.key not in self._nodes:
                    continue
                gp.children.remove(p)
                gp.rank = len(gp.children)
                p.marks = 0 if p.marks % 2 == 0 else 1
                self._add_root(p)
                gp.marks += 1
                if gp.marks > 1 and gp.parent is not None:
                    nxt.append(gp)
            frontier = nxt
        self._update_min()


class BucketStructure:
    """§5.4 bucketing: Fib-heap keyed by butterfly count; each bucket's
    value is the set of vertex/edge ids with that count."""

    def __init__(self, counts: Dict[int, int]):
        buckets: Dict[int, set] = {}
        for vid, c in counts.items():
            buckets.setdefault(int(c), set()).add(vid)
        self._heap = FibHeap()
        self._heap.batch_insert(sorted(buckets.items()))
        self._where: Dict[int, int] = {v: int(c) for v, c in counts.items()}

    def __len__(self):
        return len(self._where)

    def pop_min_bucket(self) -> Tuple[int, set]:
        key, members = self._heap.delete_min()
        for v in members:
            del self._where[v]
        return key, members

    def decrease(self, updates: Dict[int, int]):
        """Move ids to lower buckets (BUCKETING-UPDATE, Alg. 11)."""
        moves: Dict[int, set] = {}
        for vid, new_key in updates.items():
            old = self._where.get(vid)
            if old is None or new_key >= old:
                continue
            # remove from old bucket
            node_val = self._heap._nodes[old].value
            node_val.discard(vid)
            if not node_val:
                # bucket emptied: decrease its heap key if target bucket
                # missing, else delete it by merging (host shortcut).
                pass
            moves.setdefault(int(new_key), set()).add(vid)
            self._where[vid] = int(new_key)
        inserts = []
        decreases = []
        for key, members in moves.items():
            if key in self._heap:
                self._heap._nodes[key].value |= members
            else:
                # reuse an emptied bucket via decrease-key when possible
                empty = [
                    k
                    for k, nd in self._heap._nodes.items()
                    if not nd.value and k > key
                ]
                if empty:
                    src = min(empty)
                    decreases.append((src, key))
                    self._heap._nodes[src].value |= members
                else:
                    inserts.append((key, members))
        if decreases:
            self._heap.batch_decrease_key(decreases)
        if inserts:
            self._heap.batch_insert(inserts)
        # drop any remaining empty buckets lazily at pop time

    def pop_min_nonempty(self) -> Tuple[int, set]:
        while True:
            key, members = self.pop_min_bucket()
            if members:
                return key, members
