"""The port's page allocator and radix prefix trie
(``rlo_tpu_torch/serving/pages.py``) against the JAX package's
(``rlo_tpu/serving/pages.py``): the same return values, exceptions,
refcounts, statistics, ``match`` results and eviction counts over seeded
random operation sequences, plus the JAX package's own unit cases run on
the port's classes."""

import numpy as np
import pytest

from rlo_tpu.serving import pages as jpages
from rlo_tpu_torch.serving import pages as tpages

N_PAGES, PS = 12, 4


def _call(obj, name, *args):
    """(result, exception class name) of ``obj.name(*args)``."""
    try:
        return getattr(obj, name)(*args), None
    except Exception as e:  # noqa: BLE001 - compared by class name
        return None, type(e).__name__


def _state(alloc, trie):
    return ([alloc.refcount(p) for p in range(alloc.n_pages)],
            alloc.stats(), trie.entries)


def _prompt(rng, prefixes):
    """A prompt that often shares a prefix (full pages or a partial
    tail) with an earlier one."""
    if prefixes and rng.random() < 0.7:
        base = list(prefixes[int(rng.integers(len(prefixes)))])
        base = base[:int(rng.integers(1, len(base) + 1))]
    else:
        base = []
    tail = rng.integers(0, 5, int(rng.integers(0, 3 * PS))).tolist()
    return base + tail or [1]


@pytest.mark.parametrize("seed", range(8))
def test_random_operations_match_the_jax_classes(seed):
    rng = np.random.default_rng(seed)
    ja, jt = jpages.PageAllocator(N_PAGES, PS), jpages.PrefixTrie(PS)
    ta, tt = tpages.PageAllocator(N_PAGES, PS), tpages.PrefixTrie(PS)
    prefixes = []
    owned = []          # pages this "client" holds one reference on
    for _ in range(300):
        op = rng.choice(["alloc", "release", "retain", "bad", "register",
                         "match", "evict", "can"])
        if op == "alloc":
            got, want = _call(ta, "alloc"), _call(ja, "alloc")
            assert got == want
            if got[0] is not None:
                owned.append(got[0])
        elif op == "release" and owned:
            p = owned.pop(int(rng.integers(len(owned))))
            assert _call(ta, "release", p) == _call(ja, "release", p)
        elif op == "retain" and owned:
            p = owned[int(rng.integers(len(owned)))]
            assert _call(ta, "retain", p) == _call(ja, "retain", p)
            owned.append(p)
        elif op == "bad":
            # misuse raises PageError in both: the null page, a free or
            # out-of-range page
            p = int(rng.integers(-1, N_PAGES + 1))
            for name in ("retain", "release"):
                got = _call(ta, name, p)
                assert got == _call(ja, name, p)
                if got[1] is None and name == "retain":
                    owned.append(p)
                elif got[1] is None and p in owned:
                    owned.remove(p)
        elif op == "register" and owned:
            prompt = _prompt(rng, prefixes)
            need = -(-len(prompt) // PS)
            pages = [owned[int(rng.integers(len(owned)))]
                     for _ in range(need)]
            got = _call(tt, "register", prompt, len(prompt), pages, ta)
            assert got == _call(jt, "register", prompt, len(prompt), pages,
                                ja)
            prefixes.append(prompt)
        elif op == "match":
            prompt = _prompt(rng, prefixes)
            assert tt.match(prompt) == jt.match(prompt)
        elif op == "evict":
            need = int(rng.integers(1, 5))
            assert _call(tt, "evict", ta, need) == _call(jt, "evict", ja,
                                                          need)
        elif op == "can":
            n = int(rng.integers(0, N_PAGES + 2))
            assert ta.can_alloc(n) == ja.can_alloc(n)
        assert _state(ta, tt) == _state(ja, jt)
    assert (ta.free_pages, ta.pages_in_use) == (ja.free_pages,
                                                ja.pages_in_use)


def test_null_page_and_errors_are_the_reference_ones():
    assert tpages.NULL_PAGE == jpages.NULL_PAGE == 0
    assert issubclass(tpages.PageError, RuntimeError)
    for n, ps in ((1, 8), (4, 0)):
        with pytest.raises(ValueError):
            tpages.PageAllocator(n, ps)
        with pytest.raises(ValueError):
            jpages.PageAllocator(n, ps)


def test_allocator_lifecycle_and_errors():
    a = tpages.PageAllocator(5, 8)
    assert a.free_pages == 4           # page 0 is the null page
    p1, p2 = a.alloc(), a.alloc()
    assert (p1, p2) == (1, 2)          # LIFO hands out 1, 2, ...
    a.retain(p1)
    assert a.release(p1) is False      # still referenced
    assert a.release(p1) is True
    a.release(p2)
    assert a.free_pages == 4 and a.pages_in_use == 0
    assert a.alloc() == p2             # most recently freed first
    with pytest.raises(tpages.PageError):
        a.release(0)
    with pytest.raises(tpages.PageError):
        a.retain(4)
    a.release(p2)
    with pytest.raises(tpages.PageError):
        a.release(p2)
    for _ in range(4):
        assert a.alloc() is not None
    assert a.alloc() is None and a.alloc_failures == 1
    assert a.stats()["pages_peak"] == 4


def test_trie_match_register_evict():
    a = tpages.PageAllocator(10, 4)
    t = tpages.PrefixTrie(4)
    prompt = list(range(10))           # 2 full pages + 2-token tail
    pages = [a.alloc() for _ in range(3)]
    assert t.register(prompt, 10, pages, a) == 3
    assert a.refcount(pages[0]) == 2   # the trie holds its own reference
    assert t.match(prompt + [99]) == (pages, 10)
    assert t.match(list(range(8)) + [77]) == (pages[:2], 8)
    assert t.match([5, 1, 2, 3]) == ([], 0)
    assert t.register(prompt, 10, [7, 8, 9], a) == 0   # first wins
    for p in pages:
        a.release(p)
    assert a.pages_in_use == 3 == t.entries
    assert t.evict(a, 99) == 3
    assert a.pages_in_use == 0 and t.entries == 0


def test_trie_partial_tail_longest_match():
    a = tpages.PageAllocator(10, 4)
    t = tpages.PrefixTrie(4)
    short, long_ = [1, 2, 3, 4, 5], [1, 2, 3, 4, 5, 6, 7]
    t.register(short, 5, [a.alloc(), a.alloc()], a)
    t.register(long_, 7, [t.match(short)[0][0], a.alloc()], a)
    assert t.match([1, 2, 3, 4, 5, 6, 7, 8])[1] == 7
    assert t.match([1, 2, 3, 4, 5, 9])[1] == 5
