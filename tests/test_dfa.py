"""DFA compiler unit tests: dense-table walk must agree with two independent
CPU oracles on exact (end_offset, pattern_index) events."""

import numpy as np
import pytest

from pattern_matching.core.dfa import AhoCorasick, DfaTable, compile_patterns
from pattern_matching.core.oracle import match_naive, match_python
from tests.fixtures import planted_binary, random_binary


def table_scan(table: DfaTable, data: bytes) -> list[tuple[int, int]]:
    """Host-side scalar walk of the compiled dense table (test helper)."""
    goto = table.goto_signed.astype(np.int64)
    groups = table.groups_as_lists()
    s = 0
    events = []
    for i, c in enumerate(data):
        nxt = goto[s, c]
        s = -nxt if nxt < 0 else nxt
        if nxt < 0:
            for pid in groups[table.state_gid[s]]:
                events.append((i, int(pid)))
    return events


CASES = [
    # classic he/she/his/hers: co-terminations and fail-chain matches
    ([b"he", b"she", b"his", b"hers"], b"ushers and his"),
    # overlapping occurrences
    ([b"aa"], b"aaaa"),
    ([b"aba", b"ba"], b"ababab"),
    # pattern is a prefix/suffix of another
    ([b"abc", b"abcdef", b"cde"], b"xabcdefy"),
    # duplicate patterns (distinct indices, same bytes)
    ([b"dup", b"dup"], b"a dup here"),
    # single-byte patterns
    ([b"\x00", b"a"], b"a\x00b\x00a"),
    # match at position 0 and at the very end
    ([b"start", b"end"], b"start middle end"),
]


@pytest.mark.parametrize("patterns,data", CASES)
def test_table_matches_oracles(patterns, data):
    table = compile_patterns(patterns)
    got = sorted(table_scan(table, data))
    assert got == sorted(match_naive(patterns, data))
    assert got == sorted(match_python(patterns, data))


def test_planted_binary_conformance():
    patterns = [b"\xde\xad\xbe\xef", b"needle!", b"\x00\x01\x02\x03\x04"]
    data, plants = planted_binary(7, 1 << 14, patterns, 40)
    table = compile_patterns(patterns)
    got = sorted(table_scan(table, data))
    assert got == sorted(match_python(patterns, data))
    # every plant must be found (end offset = pos + len - 1)
    got_set = set(got)
    for pos, pi in plants:
        assert (pos + len(patterns[pi]) - 1, pi) in got_set


def test_random_fuzz_small_alphabet():
    # tiny alphabet maximizes fail-link stress
    rng = np.random.RandomState(3)
    for trial in range(10):
        n_pat = rng.randint(1, 8)
        patterns = [
            bytes(rng.randint(0, 3, size=rng.randint(1, 6)).astype(np.uint8))
            for _ in range(n_pat)
        ]
        data = bytes(rng.randint(0, 3, size=500).astype(np.uint8))
        table = compile_patterns(patterns)
        assert sorted(table_scan(table, data)) == sorted(
            match_python(patterns, data)
        ), f"trial {trial}: {patterns}"


def test_ushort_alphabet():
    patterns = [(40, 32, 287), (32, 287, 32, 106), (5,)]
    data = [40, 32, 287, 32, 106, 5, 40, 32, 287]
    table = compile_patterns(patterns, alphabet_size=2048)
    goto = table.goto_signed.astype(np.int64)
    s = 0
    events = []
    groups = table.groups_as_lists()
    for i, c in enumerate(data):
        nxt = goto[s, c]
        s = -nxt if nxt < 0 else nxt
        if nxt < 0:
            events.extend((i, int(p)) for p in groups[table.state_gid[s]])
    assert sorted(events) == sorted(match_naive(patterns, data))


def test_table_properties():
    table = compile_patterns([b"he", b"she", b"his", b"hers"])
    assert table.max_pat_len == 4
    assert table.num_patterns == 4
    assert table.alphabet_size == 256
    # root is never final; signed encoding unambiguous
    assert table.state_gid[0] == -1
    # goto targets in range
    assert np.abs(table.goto_signed.astype(np.int64)).max() < table.num_states
    # small automata compress to int16
    assert table.goto_signed.dtype == np.int16


def test_save_load_roundtrip(tmp_path):
    patterns = [b"he", b"she", b"his", b"hers"]
    table = compile_patterns(patterns)
    path = str(tmp_path / "dfa.npz")
    table.save(path)
    loaded = DfaTable.load(path)
    data = b"ushers and his"
    assert table_scan(loaded, data) == table_scan(table, data)
    assert [p.iid for p in loaded.patterns] == [p.iid for p in table.patterns]


def test_save_load_is_pickle_free(tmp_path):
    # --load-dfa is a shipped feature, so loading an
    # untrusted dump must not be able to execute code. The saved archive
    # must contain no pickled object arrays, labels/symbols must survive
    # the flat layout, and legacy pickled dumps must be refused by default.
    import zipfile

    import pytest

    ac = AhoCorasick()
    ac.add_pattern(b"he", iid=42, label="h\xe9 label")  # non-ascii label
    ac.add_pattern(b"\x00\xffbin", iid=-3)
    table = ac.compile()
    path = str(tmp_path / "dfa.npz")
    table.save(path)
    # every member of the archive must load with allow_pickle=False
    z = np.load(path, allow_pickle=False)
    _ = [z[k] for k in z.files]
    loaded = DfaTable.load(path)
    assert [(p.symbols, p.iid, p.label) for p in loaded.patterns] == [
        (p.symbols, p.iid, p.label) for p in table.patterns
    ]
    # a legacy (object-array) dump is refused without the explicit opt-in
    legacy = str(tmp_path / "legacy.npz")
    np.savez(
        legacy,
        goto_signed=table.goto_signed,
        state_gid=table.state_gid,
        group_state=table.group_state,
        group_offsets=table.group_offsets,
        group_pids=table.group_pids,
        group_rep=table.group_rep,
        alphabet_size=np.int64(256),
        max_pat_len=np.int64(table.max_pat_len),
        nocase=np.bool_(False),
        pat_symbols=np.array([p.symbols for p in table.patterns], object),
        pat_iids=np.array([p.iid for p in table.patterns], np.int64),
        pat_labels=np.array([p.label for p in table.patterns], object),
    )
    with pytest.raises(ValueError, match="legacy"):
        DfaTable.load(legacy)
    old = DfaTable.load(legacy, legacy_pickle=True)
    assert [p.symbols for p in old.patterns] == [
        p.symbols for p in table.patterns
    ]
    # junk archives are refused, not misparsed
    junk = str(tmp_path / "junk.npz")
    np.savez(junk, whatever=np.zeros(3))
    with pytest.raises(ValueError, match="not a DfaTable"):
        DfaTable.load(junk)
    with zipfile.ZipFile(path) as zf:  # belt & braces: no pickle opcodes
        for name in zf.namelist():
            assert not zf.read(name).startswith(b"\x93NUMPY\x01\x00v\x00{'descr': '|O"), name


def test_save_load_roundtrip_large(tmp_path):
    # flat-layout roundtrip at scale (5k patterns keeps the suite fast; the
    # 100k/300k points run in benchmarks/bench_scale.py)
    rng = np.random.RandomState(9)
    pats = [bytes(rng.randint(0, 256, size=rng.randint(4, 16)).astype(np.uint8))
            for _ in range(5000)]
    table = compile_patterns(pats)
    path = str(tmp_path / "big.npz")
    table.save(path)
    loaded = DfaTable.load(path)
    assert loaded.num_states == table.num_states
    assert len(loaded.patterns) == len(table.patterns)
    assert loaded.patterns[4999].symbols == table.patterns[4999].symbols
    data = b"junk" + pats[17] + b"junk" + pats[4321]
    assert table_scan(loaded, data) == table_scan(table, data)


def test_group_semantics():
    # "hers" ends where "hers" matches; at offset of 's' both hers and... check
    # co-termination: "she" and "he" both end at the same position in "she".
    table = compile_patterns([b"he", b"she"])
    events = table_scan(table, b"she")
    assert sorted(events) == [(2, 0), (2, 1)]


def test_large_random_sigset():
    # exercise int32 path deterministically via many patterns
    rng = np.random.RandomState(11)
    patterns = [
        bytes(rng.randint(0, 256, size=rng.randint(4, 20)).astype(np.uint8))
        for _ in range(300)
    ]
    data = random_binary(5, 1 << 13)
    # plant a few
    data = patterns[0] + data + patterns[7]
    table = compile_patterns(patterns)
    assert sorted(table_scan(table, data)) == sorted(match_python(patterns, data))


def test_nocase_matching():
    ac = AhoCorasick(nocase=True)
    ac.add_pattern(b"ViRuS")
    ac.add_pattern(b"mal")
    table = ac.compile()
    got = table_scan(table, b"VIRUS virus Virus MAL xyz")
    # ends at 4, 10, 16 for virus; 20 for mal
    assert [(o, p) for o, p in got] == [(4, 0), (10, 0), (16, 0), (20, 1)]
    # case-sensitive control
    table_cs = compile_patterns([b"ViRuS"])
    assert table_scan(table_cs, b"VIRUS virus") == []


def test_nocase_non_letters_unaffected():
    ac = AhoCorasick(nocase=True)
    ac.add_pattern(bytes([0x41, 0x00, 0x5A]))  # 'A', NUL, 'Z' -> folds to a,NUL,z
    table = ac.compile()
    assert table_scan(table, bytes([0x61, 0x00, 0x7A])) == [(2, 0)]
    assert table_scan(table, bytes([0x41, 0x00, 0x5A])) == [(2, 0)]
    assert table_scan(table, bytes([0x41, 0x20, 0x5A])) == []


def test_save_load_preserves_nocase(tmp_path):
    ac = AhoCorasick(nocase=True)
    ac.add_pattern(b"MiXeD")
    t = ac.compile()
    p = str(tmp_path / "t.npz")
    t.save(p)
    assert DfaTable.load(p).nocase is True


def test_group_construction_brute_force():
    # The vectorized match-set construction (own ∪ nearest-fail-ancestor
    # set, level-synchronous gathers + one global segment sort) against
    # first principles: group g's pid list must be the sorted indices of
    # every pattern that is a suffix of the group state's string, with
    # group_rep the smallest. Small alphabets force deep suffix chains
    # and inherited-only final states; duplicates share an end state.
    rng = np.random.RandomState(0)
    for trial in range(80):
        npat = rng.randint(1, 30)
        alpha = int(rng.choice([2, 3, 256]))
        pats = [
            bytes(rng.randint(0, alpha, size=rng.randint(1, 8)).astype(np.uint8))
            for _ in range(npat)
        ]
        if rng.rand() < 0.3:
            pats.append(pats[rng.randint(len(pats))])
        t = compile_patterns(pats)
        sy = [list(p) for p in pats]
        for i, p in enumerate(sy):
            s = 0
            for c in p:
                s = abs(int(t.goto_signed[s, c]))
            g = t.state_gid[s]
            assert g >= 0
            got = t.group_pids[t.group_offsets[g]: t.group_offsets[g + 1]].tolist()
            expect = sorted(
                j for j, q in enumerate(sy)
                if len(q) <= len(p) and p[len(p) - len(q):] == q
            )
            assert got == expect, (trial, i, got, expect)
            assert t.group_rep[g] == expect[0]
