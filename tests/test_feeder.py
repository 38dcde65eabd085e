"""Feeder tests: round-robin file ownership, batch flow, follow mode."""

import os
import threading
import time

import pytest

from pattern_matching.runtime.feeder import Feeder


def write(path, data: bytes):
    with open(path, "wb") as f:
        f.write(data)


def collect(feeder, limit=None, timeout=10.0):
    out = []
    t0 = time.time()
    for item in feeder:
        out.append(item)
        if limit and len(out) >= limit:
            feeder.stop()
        if time.time() - t0 > timeout:
            feeder.stop()
    return out


def test_single_file_batches(tmp_path):
    p = tmp_path / "a.bin"
    write(p, b"x" * 1000)
    f = Feeder([str(p)], n_workers=1, max_chunks=4, chunk_len=64, halo=0)
    f.start()
    items = collect(f)
    total = sum(i.bytes for i in items)
    assert total == 1000
    # 1000 bytes / 64B chunks = 16 chunks -> 4 batches of 4 lanes
    assert sum(i.batch.chunks for i in items) == 16


def test_round_robin_multiworker(tmp_path):
    files = []
    for i in range(5):
        p = tmp_path / f"f{i}.bin"
        write(p, bytes([i]) * (100 + i))
        files.append(str(p))
    f = Feeder(files, n_workers=3, max_chunks=8, chunk_len=64, halo=0)
    f.start()
    items = collect(f)
    assert sum(i.bytes for i in items) == sum(100 + i for i in range(5))
    # every file id appears
    fids = set()
    for it in items:
        fids.update(int(x) for x in it.batch.file_ids[: it.batch.chunks])
    assert fids == set(range(5))


def test_text_mode_lines(tmp_path):
    p = tmp_path / "t.txt"
    write(p, b"one\ntwo\nthree\n")
    f = Feeder([str(p)], n_workers=1, max_chunks=8, chunk_len=32, halo=0,
               text_mode=True)
    f.start()
    items = collect(f)
    assert sum(i.lines for i in items) == 3
    assert sum(i.bytes for i in items) == 14


def test_follow_mode_growing_file(tmp_path):
    p = tmp_path / "grow.bin"
    write(p, b"a" * 64)
    f = Feeder([str(p)], n_workers=1, max_chunks=2, chunk_len=64, halo=0,
               follow=True)
    f.start()

    got = []
    done = threading.Event()

    def consume():
        for item in f:
            got.append(item.bytes)
            if sum(got) >= 192:
                f.stop()
        done.set()

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    time.sleep(0.2)
    with open(p, "ab") as fh:  # file grows while following
        fh.write(b"b" * 128)
    assert done.wait(15), "follow mode never saw appended data"
    assert sum(got) >= 192


def test_follow_mode_fifo_trickle(tmp_path):
    # FIFOs must work in follow mode (reference README:19-22): the worker
    # must not seek the handle (ESPIPE) and must deliver trickle-fed data
    # without waiting for a full buffer
    p = tmp_path / "pipe"
    os.mkfifo(p)
    f = Feeder([str(p)], n_workers=1, max_chunks=4, chunk_len=64, halo=0,
               follow=True)
    f.start()

    def produce():
        with open(p, "wb") as fh:
            for _ in range(3):
                fh.write(b"z" * 50)  # less than one chunk per write
                fh.flush()
                time.sleep(0.15)

    t = threading.Thread(target=produce, daemon=True)
    t.start()

    got = 0
    deadline = time.time() + 20
    for item in f:
        got += item.bytes
        if got >= 150:
            f.stop()
        if time.time() > deadline:
            f.stop()
    assert got == 150


def _ushort_tokens(item):
    b = item.batch
    out = []
    for i in range(b.chunks):
        out.extend(b.data[i, b.start_t[i] : b.end_t[i]].tolist())
    return out


def _follow_ushort(tmp_path, initial: bytes, append: bytes | None,
                   want: list[int], timeout: float = 30.0):
    """Drive a follow-mode ushort feeder: read the initial text, optionally
    append once the first batch arrived, stop once ``want`` is reached (or
    on timeout), and return every token delivered in order."""
    from pattern_matching.runtime.buffers import UshortBuffer

    p = tmp_path / "flow.txt"
    write(p, initial)
    f = Feeder([str(p)], n_workers=1, max_chunks=2, chunk_len=4, halo=0,
               follow=True, buffer_factory=UshortBuffer)
    f.start()
    toks = []
    deadline = time.time() + timeout
    appended = append is None
    for item in f:
        toks.extend(_ushort_tokens(item))
        if not appended:
            with open(p, "ab") as fh:
                fh.write(append)
            appended = True
        if toks == want or len(toks) >= len(want) or time.time() > deadline:
            f.stop()
    return toks


def test_ushort_follow_revisit_no_duplicate_tokens(tmp_path):
    # follow-mode revisits used to seek the TOKEN offset
    # of a ushort stream (tokens <= text bytes), re-reading and re-parsing
    # already-consumed text -> duplicate tokens. The raw read position
    # (StreamState.text_off) is what must be seeked.
    toks = _follow_ushort(
        tmp_path, b"11,22,33,", b"44,55,", want=[11, 22, 33, 44, 55]
    )
    assert toks == [11, 22, 33, 44, 55]


def test_ushort_follow_partial_number_spans_append(tmp_path):
    # a number split by a writer pause ("12" ... "34,")
    # must parse as ONE token once the append lands, not flush as 12 early
    toks = _follow_ushort(tmp_path, b"7,12", b"34,9,", want=[7, 1234, 9])
    assert toks == [7, 1234, 9]


def test_ushort_follow_partial_number_flushed_at_shutdown(tmp_path):
    # the held partial trailing number is NOT lost when the feeder stops:
    # finalize_stream emits it as the final token
    from pattern_matching.runtime.buffers import UshortBuffer

    p = tmp_path / "flow.txt"
    write(p, b"7,12")
    f = Feeder([str(p)], n_workers=1, max_chunks=2, chunk_len=4, halo=0,
               follow=True, buffer_factory=UshortBuffer)
    f.start()
    toks = []
    for item in f:
        toks.extend(_ushort_tokens(item))
        if toks:  # first delivery: 7 arrived, "12" held -> stop now
            f.stop()
    assert toks == [7, 12]


def test_feeder_error_propagates(tmp_path):
    # a worker failure must surface to the consumer loop, not end iteration
    # silently (the reference fails loud with ERRX; silence drops matches)
    missing = str(tmp_path / "never_existed.bin")
    f = Feeder([missing], n_workers=1, max_chunks=4, chunk_len=64, halo=0)
    f.start()
    with pytest.raises(RuntimeError, match="never_existed"):
        for _ in f:
            pass


def test_feeder_error_mid_stream(tmp_path):
    # file disappears between open and read rounds: unreadable handle mid-
    # stream must also fail loud (here: a directory masquerading as a file)
    p = tmp_path / "adir"
    p.mkdir()
    f = Feeder([str(p)], n_workers=1, max_chunks=4, chunk_len=64, halo=0)
    f.start()
    with pytest.raises(RuntimeError):
        for _ in f:
            pass
