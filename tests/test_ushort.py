"""Ushort (packet-metadata) mode tests — the AC_ushorts variant."""

import numpy as np
import pytest

from pattern_matching.cli import main
from pattern_matching.core.oracle import match_naive
from pattern_matching.core.patterns import load_signature_file, parse_flow_line
from pattern_matching.ushort import compile_signatures, lanes_from_sequences


SIGS = """40,32,287,32,106,196; 6; File scanner (metasploit file scanning)
40,32,287,32,106,186,32; 7; Directory scanner
5,5,5; 3; triple five
"""


def test_signature_parsing(tmp_path):
    f = tmp_path / "sigs.txt"
    f.write_text(SIGS)
    parsed = load_signature_file(str(f))
    assert len(parsed) == 3
    assert parsed[0].data == (40, 32, 287, 32, 106, 196)
    assert parsed[0].label.startswith("File scanner")
    # truncation to max_tokens
    long = tmp_path / "long.txt"
    long.write_text(",".join(str(i) for i in range(30)) + "; 30; long\n")
    p = load_signature_file(str(long), max_tokens=16)
    assert len(p[0].data) == 16
    # atoi-parity on noisy tokens: the reference's OWN shipped traces
    # (AC_ushorts/input/*.signatures) contain tshark artifacts such as
    # "1460[Reassembly..." which its atoi parse reads as 1460
    # (iacsm_add_fullpattern, AC_ushorts/iacsmx.c:418-451); tokens with no
    # leading digits are skipped (atoi would insert 0 — saner delta)
    noisy = tmp_path / "noisy.txt"
    noisy.write_text("40,1460[ReassemblyTime=0.1],junk,32,\n")
    p = load_signature_file(str(noisy))
    assert p[0].data == (40, 1460, 32)


def test_flow_line_parsing():
    assert parse_flow_line("0,0,0,999, 89 ,10") == [0, 0, 0, 999, 89, 10]
    assert parse_flow_line("1;2;3") == [1, 2, 3]
    assert parse_flow_line("") == []


def test_ushort_match_parity(tmp_path):
    f = tmp_path / "sigs.txt"
    f.write_text(SIGS)
    table = compile_signatures(str(f))
    assert table.alphabet_size == 2048

    flow = [7, 40, 32, 287, 32, 106, 196, 9, 5, 5, 5, 5]
    data, start_t, end_t, fids, base = lanes_from_sequences(
        [(0, np.asarray(flow, np.uint16))], chunk_len=4, halo=table.max_pat_len - 1
    )
    from pattern_matching.ops.table import DeviceTable
    from pattern_matching.ops.match_xla import scan_batch
    from pattern_matching.ops.compact import compact_matches

    dev = DeviceTable.put(table)
    res = scan_batch(dev, data, start_t, end_t, halo=table.max_pat_len - 1)
    comp = compact_matches(dev, res)
    groups = table.groups_as_lists()
    got = []
    rep = int(comp.reported)
    for k in range(rep):
        ln = int(np.asarray(comp.lane)[k])
        off = int(base[ln]) + int(np.asarray(comp.pos)[k])
        for pid in groups[int(np.asarray(comp.gid)[k])]:
            got.append((off, pid))
    pats = [p.symbols for p in table.patterns]
    assert sorted(got) == sorted(match_naive(pats, flow))
    # sanity: the triple-five signature fires twice in [5,5,5,5]
    assert sum(1 for _, p in got if p == 2) == 2


def test_ushort_cli(capsys, tmp_path):
    sigs = tmp_path / "sigs.txt"
    sigs.write_text(SIGS)
    d = tmp_path / "flows"
    d.mkdir()
    (d / "10.0.0.1_444_10.0.0.2_443_tcp").write_text("7,40,32,287,32,106,196,9")
    (d / "10.0.0.3_80_10.0.0.4_443_tcp").write_text("5,5,5")
    rc = main(
        ["-f", str(d), "-p", str(sigs), "--ushort", "-v", "-B", "64", "-G", "16"]
    )
    out = capsys.readouterr().out
    assert rc == 0
    assert "File scanner" in out
    assert "triple five" in out
    assert "Matches:             2" in out


def test_ushort_out_of_range_clamped(tmp_path):
    sigs = tmp_path / "sigs.txt"
    sigs.write_text("100,200; 2; x\n")
    table = compile_signatures(str(sigs))
    flow = [65000, 100, 200, 40000]
    data, start_t, end_t, fids, base = lanes_from_sequences(
        [(0, np.asarray([min(v, 2047) for v in flow], np.uint16))],
        chunk_len=8,
        halo=table.max_pat_len - 1,
    )
    from pattern_matching.ops.table import DeviceTable
    from pattern_matching.ops.match_xla import scan_batch

    dev = DeviceTable.put(table)
    res = scan_batch(dev, data, start_t, end_t, halo=table.max_pat_len - 1)
    assert int(np.asarray(res.counts).sum()) == 1


def test_ushort_bloom_and_dense_agree(tmp_path, capsys):
    # same signature/flow fixture through both engines: identical output
    from pattern_matching.cli import main

    sig = tmp_path / "sigs"
    sig.write_text("40,1500,1500; 3; alpha\n7,7,7; 3; beta\n")
    flow = tmp_path / "flow.txt"
    flow.write_text("3, 40, 1500, 1500, 9, 7, 7, 7, 7\n")
    lines = {}
    for engine in ("bloom", "dense"):
        rc = main(["-f", str(flow), "-p", str(sig), "--ushort", "-v",
                   "--engine", engine])
        out = capsys.readouterr().out
        assert rc == 0
        lines[engine] = sorted(
            l for l in out.splitlines() if l.startswith("Pattern")
        )
    assert lines["bloom"] == lines["dense"]
    assert len(lines["bloom"]) == 3  # alpha once, beta twice (7777)


def test_ushort_bloom_ops_parity_vs_oracle():
    # ops-level: alphabet-2048 bloom + generic-width verify vs the oracle
    import numpy as np

    from pattern_matching.core.dfa import AhoCorasick
    from pattern_matching.core.oracle import match_python
    from pattern_matching.ops.bloom import (
        BloomFilterTable,
        unpack_hit_rows,
    )
    from pattern_matching.runtime.verify import Verifier

    ac = AhoCorasick(alphabet_size=2048)
    seqs = [(40, 1500, 1500), (1000, 999), (7, 7, 7, 7), (2047, 1, 2047)]
    for s in seqs:
        ac.add_pattern(s)
    table = ac.compile()
    bft = BloomFilterTable.from_table(table)
    rng = np.random.RandomState(0)
    C, B, halo = 4, 64, 8
    data = rng.randint(0, 2048, size=(C, halo + B)).astype(np.uint16)
    data[0, halo + 3 : halo + 6] = [40, 1500, 1500]
    data[1, halo + 60 :] = [1000, 999, 7, 7][:4]
    data[2, halo - 2 : halo + 2] = [7, 7, 7, 7]  # straddles the halo seam
    start_t = np.full(C, halo, np.int32)
    start_t[2] = halo - 2
    end_t = np.full(C, halo + B, np.int32)
    hits = bft.put().hits(data, np.stack([start_t, end_t]))
    rows, lanes_ = unpack_hit_rows(np.asarray(hits.bits), bft.cfg.stride)
    v = Verifier([p.symbols for p in table.patterns], alphabet_size=2048,
                 q=bft.cfg.q, max_pat_len=table.max_pat_len,
                 dense_table=table)
    got = sorted(
        (ln, e, pid)
        for ln, e, pid in v.verify_batch(
            data, lanes_, rows, halo, start_t, end_t
        )
    )
    want = []
    for ln in range(C):
        evs = match_python(
            [p.symbols for p in table.patterns],
            data[ln, start_t[ln] : end_t[ln]].tolist(),
        )
        for e, pid in evs:
            e_row = e + start_t[ln]
            if e_row >= halo:
                want.append((ln, e_row, pid))
    assert got == sorted(want)
    assert len(got) >= 3


def test_uint16_verify_without_dense_walker():
    # when the dense window walker is unavailable
    # (e.g. the >512MB table guard at large 2048-alphabet scale), uint16
    # windows fall back to the sparse oracle — which must receive symbol
    # arrays, not bytes() (that would split each uint16 into two bytes and
    # match nothing)
    import numpy as np

    from pattern_matching.runtime.verify import Verifier

    v = Verifier(
        [[300, 500, 700]], alphabet_size=2048, q=1, max_pat_len=3,
        dense_table=None,
    )
    data = np.zeros((1, 16), np.uint16)
    data[0, 5:8] = [300, 500, 700]
    events = v.verify_batch(
        data,
        cand_lanes=np.asarray([0], np.int64),
        cand_rows=np.asarray([5], np.int64),
        halo=0,
        start_t=np.zeros(1, np.int32),
        end_t=np.full(1, 16, np.int32),
    )
    assert events == [(0, 7, 0)]


def test_ushort_streams_in_rounds(tmp_path, capsys):
    # a flow corpus much larger than one batch must
    # stream through multiple feeder rounds (the reference's databuf round
    # loop, AC_ushorts/databuf.c:154-190), not a one-shot slurp
    import json

    rng = np.random.RandomState(11)
    sig = tmp_path / "sigs"
    sig.write_text("1000,1001,1002; 3; marker\n")
    flow = tmp_path / "flow.txt"
    toks = rng.randint(0, 900, size=10_000).tolist()
    for pos in (100, 5_000, 9_990):  # plant occurrences, one near the end
        toks[pos : pos + 3] = [1000, 1001, 1002]
    flow.write_text(",".join(map(str, toks)))
    rc = main(["-f", str(flow), "-p", str(sig), "--ushort", "-v",
               "-B", "64", "-G", "8", "-w", "1", "--json-stats"])
    out = capsys.readouterr().out
    assert rc == 0
    st = json.loads([l for l in out.splitlines() if l.startswith("{")][-1])
    assert st["rounds"] > 1  # streamed, not slurped
    assert st["matches_total"] == 3
    offs = sorted(
        int(l.split("sequence offset ")[1].split(" ")[0])
        for l in out.splitlines() if l.startswith("Pattern")
    )
    assert offs == [100, 5_000, 9_990]  # exact offsets incl. round seams


def test_ushort_partial_number_across_reads():
    # the incremental parser must not split a number cut by a read boundary
    from pattern_matching.runtime.buffers import parse_token_stream

    t1, rem = parse_token_stream(b"12,287", b"", final=False, clamp=2047)
    assert t1.tolist() == [12] and rem == b"287"
    # "287" + "5,9" -> token 2875 (clamped to 2047), then hold "9"
    t2, rem = parse_token_stream(b"5,9", b"287", final=False, clamp=2047)
    assert t2.tolist() == [2047] and rem == b"9"
    t3, rem = parse_token_stream(b"", b"9", final=True, clamp=2047)
    assert t3.tolist() == [9] and rem == b""


def test_parse_digit_runs_vectorized_parity():
    # the vectorized token parse (run-boundary diff + per-length Horner in
    # wrapping uint64) must equal arbitrary-precision int() & 0xFFFF for
    # every run length, including runs far past uint64 (2**16 | 2**64)
    import re

    from pattern_matching.runtime.buffers import _parse_digit_runs

    D = re.compile(rb"\d+")

    def old(buf, clamp):
        return [min(int(m) & 0xFFFF, clamp) for m in D.findall(buf)]

    rng = np.random.RandomState(0)
    chars = list(b"0123456789,; \n\tabc")
    for trial in range(60):
        buf = bytes(bytearray(int(c) for c in rng.choice(
            chars, size=rng.randint(0, 500))))
        assert _parse_digit_runs(buf, 2047).tolist() == old(buf, 2047), buf
    big = b"123456789012345678901234567890123,77,9" * 3
    assert _parse_digit_runs(big, 2047).tolist() == old(big, 2047)
    assert _parse_digit_runs(b"", 2047).tolist() == []
    assert _parse_digit_runs(b",;x", 2047).tolist() == []
    assert _parse_digit_runs(b"7", 2047).tolist() == [7]


def test_ushort_follow_mode(tmp_path):
    # -F on a growing flow file: appended tokens must be scanned, then
    # SIGINT drains cleanly with the stats block (extension: the
    # reference's ushort driver has no follow mode)
    import os
    import signal
    import subprocess
    import sys
    import time

    sig = tmp_path / "sigs"
    sig.write_text("500,501,502; 3; grow\n")
    flow = tmp_path / "flow.txt"
    flow.write_text("1,2,3,")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "pattern_matching.cli",
         "-f", str(flow), "-p", str(sig), "--ushort", "-v", "-F",
         "-B", "32", "-G", "4", "-w", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, cwd=repo,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    # poll: the appended marker is only written once the subprocess has
    # survived jax init (fixed sleeps flake under full-suite CPU load)
    import select as _select

    deadline = time.time() + 600  # loaded-host budget (r2 weak 8)
    time.sleep(20)
    with open(flow, "a") as fh:
        fh.write("500,501,502,")
    # wait until the match line appears on stdout, then interrupt
    seen = b""
    while time.time() < deadline and b"grow" not in seen:
        r, _, _ = _select.select([proc.stdout], [], [], 1.0)
        if r:
            seen += os.read(proc.stdout.fileno(), 65536)
    # the match must STREAM out while following (depth-1 pipeline + line-
    # buffered stdout) — surfacing only in the shutdown drain would mean
    # unbounded follow-mode latency (the round-3 regression this guards)
    assert b"grow" in seen, seen
    proc.send_signal(signal.SIGINT)
    out, _ = proc.communicate(timeout=900)
    out = seen + out
    assert proc.returncode == 0
    assert b"STATS" in out
    assert b"Pattern 0 ('grow')" in out  # appended occurrence was found


def test_ushort_library_find_on_flow_text():
    # MatchSession.find over flow TEXT for metadata tables: new_buffer
    # returns the token-parsing UshortBuffer for non-byte alphabets
    from pattern_matching.runtime.session import MatchSession

    import tempfile, os

    with tempfile.NamedTemporaryFile("w", suffix=".sigs", delete=False) as f:
        f.write("40,32,287; 3; alpha\n7,7,7; 3; beta\n")
        path = f.name
    try:
        table = compile_signatures(path)
        sess = MatchSession(table, max_chunks=4, chunk_len=16, engine="dense")
        got = sess.find(b"9, 40, 32, 287, 1, 7,7,7,7")
        assert got == [(3, 0), (7, 1), (8, 1)]
    finally:
        os.unlink(path)


def test_ushort_stream_longer_than_parse_swath():
    # Regression (round-3 fuzz find): UshortBuffer reads text in >= 4KB
    # swaths, so one add_stream call can leave MANY surplus parsed tokens
    # in stream.pending; scan_stream treated rd == 0 as end-of-stream and
    # dropped every batch after the surplus-only call — all events past
    # ~2 batches vanished. The stream is drained only when a NON-FULL
    # buffer reads nothing.
    import numpy as np

    from pattern_matching.core.dfa import AhoCorasick
    from pattern_matching.core.oracle import match_python
    from pattern_matching.runtime.session import MatchSession

    rng = np.random.RandomState(5)
    pats = [(3, 1, 4, 1), (2, 7, 2)]
    seq = rng.randint(0, 8, size=3000)  # ~6KB of text >> one 2x32 batch
    seq[2900:2904] = pats[0]  # deep in the tail: lost before the fix
    seq[2950:2953] = pats[1]
    want = sorted(match_python(pats, seq.tolist()))
    assert any(e >= 2900 for e, _ in want)
    ac = AhoCorasick(alphabet_size=2048)
    for p in pats:
        ac.add_pattern(p)
    table = ac.compile()
    text = (",".join(str(int(x)) for x in seq)).encode()
    got = MatchSession(
        table, max_chunks=2, chunk_len=32, engine="dense", max_results=64
    ).find(text)
    assert got == want


def test_ushort_refined_session_parity():
    # alphabet-2048 sessions now attach exact-gram refinement too (11-bit
    # key packing): the refined probe's find() must stay oracle-exact and
    # refinement must actually be on (exact_meta set) for refinable q
    import numpy as np

    from pattern_matching.core.dfa import AhoCorasick
    from pattern_matching.core.oracle import match_python
    from pattern_matching.runtime.session import MatchSession

    rng = np.random.RandomState(77)
    ac = AhoCorasick(alphabet_size=2048)
    pats = [tuple(int(x) for x in rng.randint(0, 2048, size=rng.randint(3, 7)))
            for _ in range(16)]
    for p in pats:
        ac.add_pattern(p)
    table = ac.compile()
    toks = rng.randint(0, 2048, size=600).astype(np.uint16)
    for i, pos in enumerate((3, 200, 590)):
        p = pats[i]
        toks[pos : pos + len(p)] = p
    want = sorted(match_python([list(p) for p in pats], toks.tolist()))
    flow = ",".join(str(int(t)) for t in toks).encode()  # token TEXT

    sess = MatchSession(table, max_chunks=8, chunk_len=128, engine="bloom")
    if sess.bloom_table.cfg.q * 11 <= 64:
        assert sess._bloom.exact_meta is not None  # refinement attached
        assert sess._bloom.exact_meta[-1] == 11  # at ushort symbol width
    assert sess.find(flow) == want

    # the same through the device-verify path (11-bit exact table inside
    # the windowed-walk kernel)
    sessd = MatchSession(table, max_chunks=8, chunk_len=128,
                         engine="bloom", verify="device")
    assert sessd.find(flow) == want


def test_ushort_bloom_save_load_keeps_alphabet(tmp_path):
    # the filter dump round-trips alphabet_size (and with it gram_bits),
    # so a loaded ushort filter still refines with 11-bit keys
    import numpy as np

    from pattern_matching.core.dfa import AhoCorasick
    from pattern_matching.ops.bloom import BloomFilterTable

    ac = AhoCorasick(alphabet_size=2048)
    for s in [(40, 1500, 1500), (7, 7, 7, 7)]:
        ac.add_pattern(s)
    table = ac.compile()
    bft = BloomFilterTable.from_table(table)
    path = str(tmp_path / "f.npz")
    bft.save(path)
    back = BloomFilterTable.load(path)
    assert back.alphabet_size == 2048 and back.gram_bits == 11
    if bft.gram_keys is not None:
        np.testing.assert_array_equal(back.gram_keys, bft.gram_keys)
