"""Differential fuzzing: bloom engine vs dense engine vs the independent
Python oracle on randomized pattern sets, corpora, and session geometries.

Complements the targeted boundary tests: every case asserts EXACT
(end_offset, pattern_index) agreement across all three implementations —
any divergence in halo handling, stride coverage, verify windows, masking,
or grouping shows up here."""

import numpy as np
import pytest

from pattern_matching.core.dfa import compile_patterns
from pattern_matching.core.oracle import match_python
from pattern_matching.runtime.session import MatchSession


def _random_patterns(rng, n, alphabet, lmin, lmax):
    pats = set()
    while len(pats) < n:
        ln = rng.randint(lmin, lmax + 1)
        pats.add(bytes(rng.choice(alphabet, size=ln).astype(np.uint8)))
    return sorted(pats)


def _corpus_with_plants(rng, size, pats, n_plants, alphabet):
    data = bytearray(rng.choice(alphabet, size=size).astype(np.uint8))
    for _ in range(n_plants):
        p = pats[rng.randint(len(pats))]
        pos = rng.randint(0, size - len(p) + 1)
        data[pos : pos + len(p)] = p
    return bytes(data)


CASES = [
    # (seed, n_pats, alphabet, lmin, lmax, size, plants, chunks, chunk_len)
    (0, 8, b"ab", 2, 6, 2048, 30, 4, 32),       # tiny alphabet, match-dense
    (1, 20, b"abcdefgh", 3, 10, 4096, 25, 8, 64),
    (2, 40, bytes(range(256)), 4, 16, 8192, 40, 4, 128),  # binary
    (3, 5, b"xy", 1, 3, 1024, 0, 2, 16),        # short patterns, q=1
    (4, 30, b"etaoinshrdlu ", 2, 12, 4096, 50, 16, 32),  # text-ish
    (5, 64, bytes(range(256)), 12, 12, 16384, 20, 8, 256),  # sig-like
    (6, 10, b"ab", 5, 9, 512, 80, 2, 8),        # chunk_len << pattern len
    (7, 15, bytes(range(32)), 2, 20, 4096, 10, 3, 48),  # ragged lengths
]


@pytest.mark.parametrize("case", CASES, ids=[f"case{c[0]}" for c in CASES])
def test_differential(case):
    seed, n, alpha, lmin, lmax, size, plants, chunks, clen = case
    rng = np.random.RandomState(seed)
    alphabet = np.frombuffer(bytes(alpha), np.uint8)
    pats = _random_patterns(rng, n, alphabet, lmin, lmax)
    data = _corpus_with_plants(rng, size, pats, plants, alphabet)
    want = sorted(match_python(pats, data))
    table = compile_patterns(pats)
    got_b = MatchSession(
        table, max_chunks=chunks, chunk_len=clen, engine="bloom"
    ).find(data)
    assert got_b == want, f"bloom diverged on case {seed}"
    got_d = MatchSession(
        table, max_chunks=chunks, chunk_len=clen, max_results=64,
        engine="dense",
    ).find(data)
    assert got_d == want, f"dense diverged on case {seed}"
    got_v = MatchSession(
        table, max_chunks=chunks, chunk_len=clen, engine="bloom",
        verify="device",
    ).find(data)
    assert got_v == want, f"bloom+device-verify diverged on case {seed}"
    # pattern-sharded union: S small filters OR on device; event
    # semantics must be indistinguishable from the single-filter engine
    got_s = MatchSession(
        table, max_chunks=chunks, chunk_len=clen, engine="bloom",
        pat_shards=min(3, n),
    ).find(data)
    assert got_s == want, f"bloom+pat_shards diverged on case {seed}"


def test_differential_random_geometries():
    # one pattern set, many session geometries: seams move everywhere
    rng = np.random.RandomState(99)
    alphabet = np.frombuffer(bytes(range(64)), np.uint8)
    pats = _random_patterns(rng, 12, alphabet, 3, 9)
    data = _corpus_with_plants(rng, 3000, pats, 60, alphabet)
    want = sorted(match_python(pats, data))
    table = compile_patterns(pats)
    for chunks, clen in [(2, 8), (3, 16), (5, 64), (7, 256), (64, 8)]:
        got = MatchSession(
            table, max_chunks=chunks, chunk_len=clen, engine="bloom"
        ).find(data)
        assert got == want, f"bloom diverged at geometry {(chunks, clen)}"
