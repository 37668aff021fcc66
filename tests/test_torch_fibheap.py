"""The port's host Fibonacci heap and bucket structure
(``repro_torch.core.fibheap``, paper §5) against the reference
package's ``repro.core.fibheap``: the same seeded operation sequence
goes to both, and every value either returns (minima, popped keys and
members, raised errors) must be equal (tolerance 0: keys and ids are
integers)."""
import numpy as np
import pytest

from repro.core import fibheap as ref_fib
from repro_torch.core import BucketStructure, FibHeap
from repro_torch.core import fibheap as port_fib


def heap_trace(mod, seed, n_ops=300):
    """Drive one heap of ``mod`` through seeded batch inserts,
    delete-mins and batch decrease-keys (with cascading cuts); return
    everything observable."""
    rng = np.random.default_rng(seed)
    h = mod.FibHeap()
    trace = []
    next_key = 10_000
    for _ in range(n_ops):
        op = rng.integers(0, 3)
        if op == 0 or len(h) == 0:
            k = int(rng.integers(1, 6))
            keys = next_key - 10 * np.arange(k) - rng.integers(0, 5, k)
            next_key -= 60
            keys = [int(x) for x in keys if int(x) not in h]
            h.batch_insert([(x, f"v{x}") for x in keys])
        elif op == 1:
            trace.append(("pop", h.delete_min()))
        else:
            live = sorted(h._nodes)
            pick = rng.choice(len(live), size=min(3, len(live)),
                              replace=False)
            changes, taken = [], set(live)
            for i in sorted(pick):
                old = live[int(i)]
                new = old - int(rng.integers(1, 40))
                if new in taken:
                    continue
                taken.add(new)
                changes.append((old, new))
            h.batch_decrease_key(changes)
        trace.append(("min", h.find_min(), len(h)))
    while len(h):
        trace.append(("drain", h.delete_min()))
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_fibheap_sequence_matches_reference(seed):
    assert heap_trace(port_fib, seed) == heap_trace(ref_fib, seed)


def bucket_trace(mod, seed, n=60):
    rng = np.random.default_rng(seed)
    counts = {v: int(c) for v, c in enumerate(rng.integers(0, 25, n))}
    b = mod.BucketStructure(counts)
    trace = []
    while len(b):
        key, members = b.pop_min_nonempty()
        trace.append((key, sorted(members)))
        alive = sorted(b._where)
        if alive:
            pick = rng.choice(len(alive), size=min(6, len(alive)),
                              replace=False)
            updates = {alive[int(i)]: max(key, b._where[alive[int(i)]]
                                          - int(rng.integers(0, 8)))
                       for i in pick}
            try:
                b.decrease(updates)
            except KeyError as err:
                # the structure keeps no index from an id to a bucket
                # re-keyed by an earlier decrease: both packages raise
                trace.append(("KeyError", err.args))
                return trace
            trace.append(("where", sorted(b._where.items())))
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_bucket_structure_sequence_matches_reference(seed):
    assert bucket_trace(port_fib, seed) == bucket_trace(ref_fib, seed)


def test_errors_match_reference():
    for mod in (port_fib, ref_fib):
        h = mod.FibHeap()
        h.batch_insert([(3, "a")])
        with pytest.raises(KeyError):
            h.batch_insert([(3, "b")])
        with pytest.raises(ValueError, match="must not increase"):
            h.batch_decrease_key([(3, 4)])
        with pytest.raises(KeyError):
            h.batch_decrease_key([(8, 1)])
        h.delete_min()
        with pytest.raises(IndexError):
            h.delete_min()
    assert FibHeap is port_fib.FibHeap
    assert BucketStructure is port_fib.BucketStructure
