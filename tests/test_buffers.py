"""DataBuffer unit tests (the databuf_test role, databuf.c:849-1084):
insert/validate chunks, return codes, halo assembly, reset reuse."""

import io

import numpy as np

from pattern_matching.core.dfa import compile_patterns
from pattern_matching.runtime.buffers import DataBuffer, StreamState
from pattern_matching.runtime.session import MatchSession


def test_binary_vectorized_assembly():
    B, H, C = 64, 16, 8
    data = bytes(range(256)) * 2  # 512 bytes -> 8 chunks
    buf = DataBuffer(C, B, H)
    stream = StreamState(file_id=3)
    code, rd = buf.add_stream(io.BytesIO(data), stream)
    assert rd == 512 and code == -1 and buf.chunks == 8
    for i in range(8):
        assert bytes(buf.data[i, H : H + B]) == data[i * B : (i + 1) * B]
        if i == 0:
            assert buf.start_t[0] == H  # no history
        else:
            assert buf.start_t[i] == 0
            assert bytes(buf.data[i, 0:H]) == data[i * B - H : i * B]
        assert buf.base_off[i] == i * B
        assert buf.file_ids[i] == 3
    assert stream.tail == data[-H:]


def test_short_tail_and_codes():
    buf = DataBuffer(4, 64, 8)
    stream = StreamState(file_id=0)
    code, rd = buf.add_stream(io.BytesIO(b"x" * 100), stream)
    assert rd == 100
    assert buf.chunks == 2
    assert buf.end_t[1] == 8 + 36  # tail chunk masked at true length
    assert code == 2  # two lanes free


def test_reset_reuse_no_stale_matches():
    # second batch reuses the buffer without zeroing; stale bytes must not
    # produce matches (masking contract)
    patterns = [b"zzzz"]
    sess = MatchSession(compile_patterns(patterns), max_chunks=4, chunk_len=64)
    buf = sess.new_buffer()
    s1 = StreamState(file_id=0)
    buf.add_stream(io.BytesIO(b"zzzz" + b"a" * 200), s1)
    bm1 = sess.scan_and_decode(buf.to_batch())
    assert bm1.total == 1
    buf.reset()
    # refill with shorter, match-free data; stale 'zzzz' bytes remain in
    # the data array beyond the new end_t
    s2 = StreamState(file_id=1)
    buf.add_stream(io.BytesIO(b"b" * 10), s2)
    bm2 = sess.scan_and_decode(buf.to_batch())
    assert bm2.total == 0


def test_add_chunk_codes():
    buf = DataBuffer(2, 32, 0)
    s = StreamState(file_id=0)
    assert buf.add_chunk(b"x" * 40, s) == -3  # too large
    assert buf.add_chunk(b"x" * 16, s) == 1  # one lane left
    assert buf.add_chunk(b"y" * 16, s) == -1  # now full


def test_tiny_chunks_halo_larger_than_chunk():
    # H > B exercises the per-chunk fallback path
    patterns = [b"q" * 40]
    sess = MatchSession(compile_patterns(patterns), max_chunks=32, chunk_len=16)
    assert sess.halo > 16
    data = b"pp" + b"q" * 40 + b"pp"
    assert sess.find(data) == [(41, 0)]


def test_stream_state_resume_across_sessions():
    # SURVEY aux: the reference's only stream-resume state is one
    # `last_state` long (databuf.h:35); here it's the plain-data StreamState
    # (tail bytes + offset) — serializable, and resuming mid-stream finds
    # matches that straddle the suspension point
    import io
    import pickle

    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.core.oracle import match_python
    from pattern_matching.runtime.session import MatchSession

    pats = [b"straddle!"]
    part1 = b"x" * 100 + b"strad"
    part2 = b"dle!" + b"y" * 50 + b"straddle!"
    full = part1 + part2
    want = sorted(match_python(pats, full))

    sess = MatchSession(compile_patterns(pats), max_chunks=2, chunk_len=32)
    buf = sess.new_buffer()
    stream = StreamState(file_id=0)
    events = []

    def drain(fobj, stream, buf):
        got = []
        while True:
            code, rd = buf.add_stream(fobj, stream)
            if buf.chunks and (code == -1 or rd == 0):
                bm = sess.scan_and_decode(buf.to_batch())
                got.extend(ev for b in [bm] for ev in b.events)
                buf.reset()
            if rd == 0:
                return got

    events += drain(io.BytesIO(part1), stream, buf)
    # suspend: persist the continuity state, then resume in a NEW buffer
    blob = pickle.dumps(stream)
    stream2 = pickle.loads(blob)
    buf2 = sess.new_buffer()
    events += drain(io.BytesIO(part2), stream2, buf2)
    got = sorted(
        (ev.end_offset, p) for ev in events for p in ev.pattern_indices
    )
    assert got == want


def test_scan_stream_bounded_buffers_and_memory():
    """The databuf contract made checkable: a stream
    hundreds of times the buffer capacity allocates at most depth+1
    buffers (rotated via reset(), never re-allocated) and host RSS stays
    flat across batches."""
    import os

    from pattern_matching.core.oracle import match_python

    def rss_kb() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * (os.sysconf("SC_PAGESIZE") // 1024)

    pats = [b"needle!"]
    table = compile_patterns(pats)
    depth = 4
    sess = MatchSession(table, max_chunks=4, chunk_len=64, engine="dense")
    # capacity = 4 * 64 = 256 payload bytes/batch; stream ~200 batches
    data = (b"x" * 997 + b"needle!") * 50
    want = len(match_python(pats, data))

    # warm the jit caches with one full pass so the measured pass sees
    # steady state (compile allocations are one-time, not per-batch)
    sum(1 for _ in sess.scan_stream(io.BytesIO(data), depth=depth))

    n0 = DataBuffer.alloc_count
    rss0 = rss_kb()
    got = 0
    for bm in sess.scan_stream(io.BytesIO(data), depth=depth):
        got += len(bm.events)
    assert got == want
    assert DataBuffer.alloc_count - n0 <= depth + 1, (
        DataBuffer.alloc_count - n0
    )
    # flat RSS: ~200 batches of churn must not accumulate host memory
    # (generous slack for allocator noise on a shared host)
    assert rss_kb() - rss0 < 32 * 1024, (rss0, rss_kb())
