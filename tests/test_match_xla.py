"""Scan engine conformance: the device DFA walk + compaction must reproduce
the CPU oracle's exact (end_offset, pattern_index) events across chunk,
batch, and fragment boundaries."""

import io

import numpy as np
import pytest

from pattern_matching.core.dfa import compile_patterns
from pattern_matching.core.oracle import match_python
from pattern_matching.runtime.session import MatchSession
from tests.fixtures import planted_binary, random_words_corpus


def oracle(patterns, data):
    return sorted(match_python(patterns, data))


def test_single_small_chunk():
    patterns = [b"he", b"she", b"his", b"hers"]
    sess = MatchSession(compile_patterns(patterns), max_chunks=4, chunk_len=64)
    assert sess.find(b"ushers and his") == oracle(patterns, b"ushers and his")


def test_match_at_chunk_boundaries():
    # pattern straddles every chunk boundary: chunk_len 8, pattern length 5
    patterns = [b"abcde"]
    data = b"".join(b"xxx" + b"abcde" for _ in range(20))
    sess = MatchSession(compile_patterns(patterns), max_chunks=8, chunk_len=8)
    assert sess.find(data) == oracle(patterns, data)


def test_match_straddles_batch_boundary():
    # buffer = 2 chunks x 8 bytes = 16 bytes/batch; matches cross batches
    patterns = [b"abcdefgh", b"12345"]
    data = b"zz" + b"abcdefgh" + b"q" * 9 + b"12345" + b"abcdefgh" * 3
    sess = MatchSession(compile_patterns(patterns), max_chunks=2, chunk_len=8)
    assert sess.find(data) == oracle(patterns, data)


def test_no_false_match_from_padding():
    # short tail chunk: zero padding must NOT create matches for patterns
    # containing 0x00 (a real false-positive bug in the reference's padding)
    patterns = [b"ab\x00\x00"]
    data = b"xxxxxxab"  # tail chunk ends exactly with 'ab'; padding is zeros
    sess = MatchSession(compile_patterns(patterns), max_chunks=4, chunk_len=8)
    assert sess.find(data) == []
    # and the genuine occurrence is still found
    data2 = b"xxab\x00\x00yy"
    assert sess.find(data2) == oracle(patterns, data2)


def test_no_false_match_from_missing_history():
    # first chunk of a stream has no history: halo is masked, so a pattern
    # whose prefix would be "provided" by zero-fill must not fire
    patterns = [b"\x00\x00ab"]
    data = b"abzzzz"
    sess = MatchSession(compile_patterns(patterns), max_chunks=4, chunk_len=4)
    assert sess.find(data) == []
    data2 = b"q\x00\x00abzz"
    assert sess.find(data2) == oracle(patterns, data2)


def test_overlapping_and_repeated():
    patterns = [b"aa", b"aaa"]
    data = b"a" * 50
    sess = MatchSession(compile_patterns(patterns), max_chunks=4, chunk_len=8)
    assert sess.find(data) == oracle(patterns, data)


def test_planted_binary_multi_batch():
    patterns = [b"\xde\xad\xbe\xef", b"needle!", b"\x01\x02\x03\x04\x05\x06"]
    data, plants = planted_binary(13, 1 << 15, patterns, 60)
    sess = MatchSession(compile_patterns(patterns), max_chunks=16, chunk_len=256)
    got = sess.find(data)
    assert got == oracle(patterns, data)
    got_set = set(got)
    for pos, pi in plants:
        assert (pos + len(patterns[pi]) - 1, pi) in got_set


def test_text_mode_lines_independent():
    # matches must not span different lines, even without zero padding
    patterns = [b"ab", b"b\na"]  # second contains a newline: can only match
    # inside a single lane if lines were glued — they must not be
    sess = MatchSession(compile_patterns(patterns), max_chunks=8, chunk_len=32)
    data = b"xxb\nabyy\n"
    got = sess.find(data, text_mode=True)
    # oracle on the full stream WOULD find b"b\na" at offset 4; text mode
    # must not (lines are independent), but must find "ab" inside line 2.
    assert got == [(5, 0)]


def test_text_mode_long_line_fragments():
    # a line longer than chunk_len splits into halo-linked fragments;
    # matches across the fragment boundary must be found
    patterns = [b"abcdef"]
    line = b"x" * 29 + b"abcdef" + b"y" * 29  # fragment boundary at 32
    data = line + b"\n" + line + b"\n"
    sess = MatchSession(compile_patterns(patterns), max_chunks=8, chunk_len=32)
    got = sess.find(data, text_mode=True)
    assert got == oracle(patterns, data)


def test_word_corpus_text_mode():
    patterns, corpus = random_words_corpus(seed=5, n_lines=200)
    sess = MatchSession(compile_patterns(patterns), max_chunks=64, chunk_len=128)
    got = sess.find(corpus, text_mode=True)
    # every oracle event not containing a newline span must be found;
    # since patterns have no newlines, full parity holds
    assert got == oracle(patterns, corpus)


def test_exact_total_with_slot_overflow():
    # dense-engine slot semantics under test: pin engine="dense"
    patterns = [b"aa"]
    data = b"a" * 64  # 63 events in one 64-byte chunk >> max_results
    table = compile_patterns(patterns)
    sess = MatchSession(table, max_chunks=2, chunk_len=64, max_results=4, engine="dense")
    buf = sess.new_buffer()
    from pattern_matching.runtime.buffers import StreamState

    buf.add_stream(io.BytesIO(data), StreamState(file_id=0))
    bm = sess.scan_and_decode(buf.to_batch())
    assert bm.total == 63  # exact even though only 4 slots exist
    assert bm.overflowed
    assert bm.reported == 4  # slots hold the first max_results matches


def test_sorted_compaction():
    patterns = [b"ab"]
    data = b"ab" * 40
    table = compile_patterns(patterns)
    sess = MatchSession(table, max_chunks=8, chunk_len=16, sort=True)
    buf = sess.new_buffer()
    from pattern_matching.runtime.buffers import StreamState

    buf.add_stream(io.BytesIO(data), StreamState(file_id=0))
    bm = sess.scan_and_decode(buf.to_batch())
    offs = [e.end_offset for e in bm.events]
    assert offs == sorted(offs)
    assert offs == [o for (o, _) in oracle(patterns, data)]


def test_group_counts_device():
    patterns = [b"he", b"she", b"cat"]
    data = b"she her cat shed cats"
    table = compile_patterns(patterns)
    sess = MatchSession(table, max_chunks=4, chunk_len=32, engine="dense")
    buf = sess.new_buffer()
    from pattern_matching.runtime.buffers import StreamState

    buf.add_stream(io.BytesIO(data), StreamState(file_id=0))
    comp = sess.scan(buf.to_batch())
    gc = sess.group_counts(comp)
    # total group events == total match positions
    ev = match_python(patterns, data)
    positions = {off for off, _ in ev}
    assert gc.sum() == len(positions)


def test_group_counts_exact_past_slot_overflow():
    # per-group counts must stay exact when lanes
    # overflow their R result slots (match-dense input, the config-5
    # count-workload shape) — the in-scan gcounts count every report, not
    # just the stored slots
    rng = np.random.RandomState(3)
    pats = list({bytes(rng.randint(0, 2, size=4).astype(np.uint8))
                 for _ in range(6)})
    data = bytes(rng.randint(0, 2, size=4096).astype(np.uint8))
    sess = MatchSession(compile_patterns(pats), max_chunks=4,
                        chunk_len=256, engine="dense", max_results=4)
    buf = sess.new_buffer()
    from pattern_matching.runtime.buffers import StreamState

    stream = StreamState(file_id=0)
    fobj = io.BytesIO(data)
    want = np.zeros(sess.table.num_groups, np.int64)
    positions = {}
    for off, pid in match_python(pats, data):
        positions.setdefault(off, set()).add(pid)
    gid_of = {tuple(sorted(p)): g
              for g, p in enumerate(sess.table.groups_as_lists())}
    for pids in positions.values():
        want[gid_of[tuple(sorted(pids))]] += 1
    got = np.zeros_like(want)
    total = 0
    overflowed = False
    while True:
        code, rd = buf.add_stream(fobj, stream)
        if buf.chunks and (code == -1 or rd == 0):
            batch = buf.to_batch()
            comp = sess.scan(batch)
            meta = np.asarray(comp.meta)
            overflowed |= meta[0] > meta[1]
            t, g = sess.decode_counts(batch, comp)
            total += t
            got += g
            buf.reset()
        if rd == 0:
            break
    assert overflowed, "test must actually overflow the slots"
    assert total == len(positions)
    assert (got == want).all()


def test_multi_file_ids():
    patterns = [b"zz"]
    table = compile_patterns(patterns)
    sess = MatchSession(table, max_chunks=8, chunk_len=16)
    buf = sess.new_buffer()
    from pattern_matching.runtime.buffers import StreamState

    buf.add_stream(io.BytesIO(b"aazzbb"), StreamState(file_id=7))
    buf.add_stream(io.BytesIO(b"zz"), StreamState(file_id=9))
    bm = sess.scan_and_decode(buf.to_batch())
    got = sorted((e.file_id, e.end_offset) for e in bm.events)
    assert got == [(7, 3), (9, 1)]


def test_find_raises_on_slot_overflow():
    # find() is the "give me ALL matches" API: silent partial results on
    # R-slot overflow (found by the round-2 fuzz campaign on match-dense
    # binary-alphabet data) must be a loud error, with the workaround in
    # the message; raising max_results yields the exact oracle set
    import numpy as np
    import pytest

    from pattern_matching.core.oracle import match_python

    rng = np.random.RandomState(0)
    pats = list({bytes(rng.randint(0, 2, size=5).astype(np.uint8))
                 for _ in range(8)})
    data = bytes(rng.randint(0, 2, size=2000).astype(np.uint8))
    sess = MatchSession(compile_patterns(pats), max_chunks=2,
                        chunk_len=256, engine="dense")
    with pytest.raises(RuntimeError, match="max_results"):
        sess.find(data)
    big = MatchSession(compile_patterns(pats), max_chunks=2, chunk_len=256,
                       engine="dense", max_results=512)
    assert big.find(data) == sorted(match_python(pats, data))
