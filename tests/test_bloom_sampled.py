"""Winnowing-sampled bloom engine conformance (cfg.sampled).

The sampled mode inserts only each pattern's per-window rightargmin grams
and tests only winnowing-selected text positions — the large-pattern-set
regime (ops/bloom.py). Device selection (a+b >= w-1 rule in the
kernel) must agree exactly with the host fingerprint builder
(_winnow_offsets), or matches silently vanish; everything here is checked
against the independent CPU oracle.
"""

import numpy as np
import pytest

from pattern_matching.core.dfa import compile_patterns
from pattern_matching.core.oracle import match_python
from pattern_matching.ops.bloom import (
    BloomFilterTable,
    _gram_m1,
    _sel_hash_np,
    _winnow_grams,
    _winnow_offsets,
)
from pattern_matching.runtime.session import MatchSession


def sampled_session(pats, **kw):
    kw.setdefault("engine", "bloom")
    kw.setdefault("bloom_opts", {"mode": "sampled"})
    sess = MatchSession(compile_patterns(pats), **kw)
    assert sess.bloom_table.cfg.sampled
    assert sess.bloom_table.cfg.stride == 1
    return sess


def test_sampled_oracle_parity_random():
    rng = np.random.RandomState(7)
    pats = [
        bytes(rng.randint(0, 256, size=rng.randint(8, 16)).astype(np.uint8))
        for _ in range(64)
    ]
    data = bytearray(rng.randint(0, 256, size=1 << 14).astype(np.uint8))
    for i, pos in enumerate([0, 100, 4090, 8191, 16000]):
        p = pats[i % len(pats)]
        data[pos : pos + len(p)] = p  # incl. chunk-boundary straddles
    data = bytes(data)
    sess = sampled_session(pats, max_chunks=8, chunk_len=512)
    assert sess.find(data) == sorted(match_python(pats, data))


def test_sampled_identical_gram_runs():
    # all-equal selection hashes are the tie-rule stress case: a run of one
    # byte makes every gram identical; the device's >= / > asymmetry must
    # match the builder's rightmost-argmin exactly
    pats = [b"aaaaaaaa", b"aaab"]
    data = b"b" + b"a" * 500 + b"b" + b"a" * 3 + b"b" + b"aaab"
    sess = sampled_session(pats, max_chunks=4, chunk_len=128)
    assert sess.find(data) == sorted(match_python(pats, data))


def test_sampled_text_mode_and_short_lanes():
    pats = [b"needle", b"haystack"]
    lines = (b"the needle is here\n" b"no match\n" b"haystack haystack\n") * 20
    sess = sampled_session(pats, max_chunks=8, chunk_len=64)
    assert sess.find(lines, text_mode=True) == sorted(
        match_python(pats, lines)
    )


def test_sampled_fuzz_vs_dense():
    rng = np.random.RandomState(3)
    alpha = b"abcd"  # tiny alphabet: match-dense, heavy hash ties
    for trial in range(4):
        pats = list(
            {
                bytes(alpha[rng.randint(4)] for _ in range(rng.randint(6, 10)))
                for _ in range(12)
            }
        )
        data = bytes(alpha[rng.randint(4)] for _ in range(4096))
        sess_s = sampled_session(pats, max_chunks=4, chunk_len=256)
        sess_d = MatchSession(
            compile_patterns(pats), max_chunks=4, chunk_len=256,
            engine="dense",
        )
        assert sess_s.find(data) == sess_d.find(data), trial


def test_winnow_device_host_rule_equivalence():
    # the kernel's a+b >= w-1 characterization == "rightargmin of some
    # w-window", brute-forced on random hash sequences incl. ties
    rng = np.random.RandomState(11)
    for trial in range(200):
        m = rng.randint(4, 30)
        w = rng.randint(1, min(m, 9) + 1)
        h = rng.randint(0, 6, size=m)  # small range: many ties
        want = set(_winnow_offsets(h, w))
        got = set()
        for p in range(m):
            a = 0
            while p - a - 1 >= 0 and h[p - a - 1] >= h[p]:
                a += 1
            b = 0
            while p + b + 1 < m and h[p + b + 1] > h[p]:
                b += 1
            # device clamps window extent to w-1 on each side implicitly
            if min(a, w - 1) + min(b, w - 1) >= w - 1:
                got.add(p)
        assert got == want, (trial, h.tolist(), w, got, want)


def test_winnow_grams_matches_reference_impl():
    rng = np.random.RandomState(5)
    pats = [
        [int(x) for x in rng.randint(0, 256, size=rng.randint(10, 20))]
        for _ in range(200)
    ]
    mix = tuple(range(1, 17, 2))
    for q, w in ((3, 4), (4, 7), (8, 3)):
        ref = set()
        for p in pats:
            h = _sel_hash_np(_gram_m1(p, q, mix))
            for o in _winnow_offsets(h, w):
                ref.add(tuple(p[o : o + q]))
        assert _winnow_grams(pats, q, w, mix) == ref


def test_chooser_picks_sampled_for_large_sets():
    rng = np.random.RandomState(42)
    pats = [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(30_000)]
    bft = BloomFilterTable.build(pats)
    assert bft.cfg.sampled  # strided k*v cannot hold 4x30k grams at target
    # at most one fingerprint per w-window: (L - q + 1) - w + 1 windows per
    # pattern at L == Lmin, fewer grams than any stride >= 2 inserts
    cfg = bft.cfg
    windows = (12 - cfg.q + 1) - cfg.w + 1
    assert windows <= 2
    assert bft.n_grams <= len(pats) * windows
    # forced strided still builds (fallback past fp target)
    bft_s = BloomFilterTable.build(pats[:1000], mode="strided")
    assert not bft_s.cfg.sampled


def test_sampled_save_load_roundtrip(tmp_path):
    pats = [b"abcdefgh", b"12345678"]
    bft = BloomFilterTable.build(pats, mode="sampled")
    path = str(tmp_path / "bloom.npz")
    bft.save(path)
    back = BloomFilterTable.load(path)
    assert back.cfg == bft.cfg
    np.testing.assert_array_equal(back.words, bft.words)


def test_sampled_rejects_too_short_patterns():
    with pytest.raises(ValueError, match="too short"):
        _winnow_grams([[1, 2, 3]], q=2, w=5, mix1=(3, 5))


def test_sampled_under_mesh():
    # the sampled kernel through MatchSession(mesh=): shard_map + the
    # three-view overlapping BlockSpecs must compose
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    rng = np.random.RandomState(13)
    pats = [bytes(rng.randint(0, 256, size=10).astype(np.uint8))
            for _ in range(32)]
    data = bytearray(rng.randint(0, 256, size=1 << 13).astype(np.uint8))
    for pos in (5, 4000, 8100):
        data[pos : pos + 10] = pats[pos % 32]
    data = bytes(data)
    sess = MatchSession(
        compile_patterns(pats), max_chunks=16, chunk_len=64,
        engine="bloom", bloom_opts={"mode": "sampled"}, mesh="all",
    )
    assert sess.bloom_table.cfg.sampled
    assert sess.find(data) == sorted(match_python(pats, data))


def test_sampled_nocase():
    # fold_case folds input symbols in-kernel BEFORE the selection hash;
    # patterns are compile-time folded — both sides must agree
    from pattern_matching.core.dfa import AhoCorasick

    ac = AhoCorasick(nocase=True)
    for p in (b"NeEdLe", b"HAYSTACK"):
        ac.add_pattern(p)
    table = ac.compile()
    sess = MatchSession(table, max_chunks=4, chunk_len=128,
                        engine="bloom", bloom_opts={"mode": "sampled"})
    data = b"xx needle yy HaYsTaCk zz NEEDLE"
    got = sess.find(data)
    folded = bytes(c + 32 if 65 <= c <= 90 else c for c in data)
    want = sorted(match_python([b"needle", b"haystack"], folded))
    assert got == want and len(got) == 3


def test_sampled_ushort_alphabet():
    # winnowing over the 2048 metadata alphabet (uint16 lanes)
    from pattern_matching.core.dfa import AhoCorasick
    from pattern_matching.ops.bloom import unpack_hit_rows
    from pattern_matching.runtime.verify import Verifier

    ac = AhoCorasick(alphabet_size=2048)
    sigs = [(40, 32, 287, 32, 106, 196), (1500, 1500, 40, 9),
            (7, 7, 7, 7, 7)]
    for s in sigs:
        ac.add_pattern(s)
    table = ac.compile()
    bft = BloomFilterTable.from_table(table, mode="sampled")
    assert bft.cfg.sampled
    rng = np.random.RandomState(2)
    C, B, halo = 4, 256, 8
    data = rng.randint(0, 2048, size=(C, halo + B)).astype(np.uint16)
    data[0, halo + 10 : halo + 16] = sigs[0]
    data[2, halo + 200 : halo + 205] = sigs[2]
    start_t = np.full(C, halo, np.int32)
    end_t = np.full(C, halo + B, np.int32)
    hits = bft.put().hits(data, np.stack([start_t, end_t]))
    rows, lanes = unpack_hit_rows(np.asarray(hits.bits), bft.cfg.stride)
    v = Verifier([p.symbols for p in table.patterns], alphabet_size=2048,
                 q=bft.cfg.q, max_pat_len=table.max_pat_len,
                 dense_table=table)
    got = sorted(set(v.verify_batch(data, lanes, rows, halo,
                                    start_t, end_t)))
    want = []
    for ln in range(C):
        for e, pid in match_python(
            [p.symbols for p in table.patterns], data[ln, halo:].tolist()
        ):
            want.append((ln, e + halo, pid))
    assert got == sorted(want) and len(got) >= 2
