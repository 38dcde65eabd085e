"""CLI end-to-end tests (in-process main())."""

import io
import os

import pytest

from pattern_matching.cli import main
from tests.fixtures import random_words_corpus


@pytest.fixture()
def corpus_dir(tmp_path):
    patterns, corpus = random_words_corpus(seed=9, n_lines=150)
    pat_file = tmp_path / "patterns.txt"
    pat_file.write_bytes(b"\n".join(patterns) + b"\n")
    data_file = tmp_path / "input.txt"
    data_file.write_bytes(corpus)
    return tmp_path, str(pat_file), str(data_file), patterns, corpus


def run_cli(capsys, argv):
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, out


def test_basic_grep(capsys, corpus_dir):
    tmp, pat, data, patterns, corpus = corpus_dir
    rc, out = run_cli(
        capsys, ["-f", data, "-p", pat, "-B", "256", "-G", "64", "-v", "-w", "1"]
    )
    assert rc == 0
    assert "STATS" in out
    # verify each reported match against the corpus
    n_matches = 0
    for line in out.splitlines():
        if line.startswith("Pattern "):
            n_matches += 1
            label = line.split("('")[1].split("')")[0]
            off = int(line.split("at offset ")[1].split(" ")[0])
            assert corpus[off : off + len(label)] == label.encode()
    # ground truth: total occurrences of all patterns
    expect = sum(corpus.count(p) for p in patterns)
    assert n_matches == expect
    assert f"Matches:             {expect}" in out


def test_text_mode_and_lines(capsys, corpus_dir):
    tmp, pat, data, patterns, corpus = corpus_dir
    rc, out = run_cli(
        capsys, ["-f", data, "-p", pat, "-B", "256", "-G", "64", "-t", "-w", "1"]
    )
    assert rc == 0
    n_lines = corpus.count(b"\n")
    assert f"Processed lines:     {n_lines}" in out


def test_multi_file_and_threads(capsys, corpus_dir, tmp_path):
    tmp, pat, data, patterns, corpus = corpus_dir
    # split corpus into 3 files, pass comma-separated, 2 feeder threads
    third = len(corpus) // 3
    f1 = tmp_path / "a.bin"
    f2 = tmp_path / "b.bin"
    f3 = tmp_path / "c.bin"
    f1.write_bytes(corpus[:third])
    f2.write_bytes(corpus[third : 2 * third])
    f3.write_bytes(corpus[2 * third :])
    rc, out = run_cli(
        capsys,
        ["-f", f"{f1},{f2},{f3}", "-p", pat, "-B", "128", "-G", "32", "-w", "2"],
    )
    assert rc == 0
    assert "Processed files:     3" in out
    # totals across split files: only matches fully inside one file are
    # guaranteed (split points may cut occurrences)
    expect_min = sum(
        part.count(p)
        for part in (corpus[:third], corpus[third : 2 * third], corpus[2 * third :])
        for p in patterns
    )
    got = int(out.split("Matches:")[1].splitlines()[0])
    assert got == expect_min


def test_directory_input(capsys, corpus_dir, tmp_path):
    tmp, pat, data, patterns, corpus = corpus_dir
    d = tmp_path / "dir"
    d.mkdir()
    (d / "x.txt").write_bytes(corpus)
    rc, out = run_cli(capsys, ["-f", str(d), "-p", pat, "-B", "256", "-G", "64"])
    assert rc == 0
    expect = sum(corpus.count(p) for p in patterns)
    assert f"Matches:             {expect}" in out


def test_hex_patterns(capsys, tmp_path):
    pat = tmp_path / "hex.txt"
    pat.write_text("deadbeef\n00ff00\n")
    data = tmp_path / "d.bin"
    data.write_bytes(b"xx\xde\xad\xbe\xefyy\x00\xff\x00zz\xde\xad\xbe\xef")
    rc, out = run_cli(
        capsys, ["-f", str(data), "-p", str(pat), "-x", "-v", "-B", "64", "-G", "16"]
    )
    assert rc == 0
    assert "Matches:             3" in out


def test_pat_size_limit(capsys, tmp_path):
    # -m truncates patterns: 'abcdef' limited to 3 becomes 'abc'
    pat = tmp_path / "p.txt"
    pat.write_text("abcdef\n")
    data = tmp_path / "d.bin"
    data.write_bytes(b"abcxxx")
    rc, out = run_cli(
        capsys,
        ["-f", str(data), "-p", str(pat), "-m", "3", "-v", "-B", "64", "-G", "16"],
    )
    assert rc == 0
    assert "Matches:             1" in out


def test_save_load_dfa(capsys, corpus_dir, tmp_path):
    tmp, pat, data, patterns, corpus = corpus_dir
    dfa = str(tmp_path / "c.npz")
    rc, out1 = run_cli(
        capsys,
        ["-f", data, "-p", pat, "-B", "256", "-G", "64", "--save-dfa", dfa],
    )
    assert rc == 0 and os.path.exists(dfa)
    rc, out2 = run_cli(
        capsys, ["-f", data, "--load-dfa", dfa, "-B", "256", "-G", "64"]
    )
    assert rc == 0
    m1 = out1.split("Matches:")[1].splitlines()[0]
    m2 = out2.split("Matches:")[1].splitlines()[0]
    assert m1 == m2


def test_json_stats(capsys, corpus_dir):
    tmp, pat, data, patterns, corpus = corpus_dir
    rc, out = run_cli(
        capsys,
        ["-f", data, "-p", pat, "-B", "256", "-G", "64", "--json-stats"],
    )
    assert rc == 0
    import json

    line = [l for l in out.splitlines() if l.startswith("{")][-1]
    st = json.loads(line)
    assert st["bytes"] == len(corpus)
    assert st["files"] == 1


def test_categorical_pattern_ids(capsys, tmp_path):
    pat = tmp_path / "p.txt"
    pat.write_text('-5 "bad"\n7 "good"\n')
    data = tmp_path / "d.txt"
    data.write_bytes(b"good bad good")
    rc, out = run_cli(
        capsys, ["-f", str(data), "-p", str(pat), "-v", "-B", "64", "-G", "16"]
    )
    assert rc == 0
    assert "Pattern 7 ('good')" in out
    assert "Pattern -5 ('bad')" in out
    assert "Matches:             3" in out


def test_engine_flag_all_engines_agree(capsys, corpus_dir):
    tmp, pat, data, patterns, corpus = corpus_dir
    outs = {}
    for engine in ("bloom", "dense"):
        rc, out = run_cli(
            capsys,
            ["-f", data, "-p", pat, "-B", "64", "-G", "16", "-t", "-v",
             "-w", "1", "--sort", "--engine", engine],
        )
        assert rc == 0
        outs[engine] = sorted(
            l for l in out.splitlines() if l.startswith("Pattern")
        )
    assert outs["bloom"] == outs["dense"]
    assert len(outs["bloom"]) > 0


def test_sigint_drains_and_flushes(corpus_dir, tmp_path):
    # the reference's SIGINT handler sets terminate and workers flush a
    # final batch (ocl_aho_grep.c:25-31, 61-65); follow mode + SIGINT must
    # exit cleanly with the stats block
    import signal
    import subprocess
    import sys
    import time

    import select

    tmp, pat, data, patterns, corpus = corpus_dir
    proc = subprocess.Popen(
        [sys.executable, "-m", "pattern_matching.cli",
         "-f", data, "-p", pat, "-t", "-F", "-w", "1", "-v",
         "-B", "64", "-G", "16"],
        stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    # wait for scan output before interrupting (fixed sleeps flake under
    # full-suite CPU load while the subprocess compiles jax). Budget sized
    # for a fully loaded one-core host: the child cannot even ACT on
    # SIGINT while a compile holds the interpreter (240s has expired
    # under suite-wide contention).
    seen = b""
    deadline = time.time() + 600
    while time.time() < deadline and b"Pattern" not in seen:
        r, _, _ = select.select([proc.stdout], [], [], 1.0)
        if r:
            seen += os.read(proc.stdout.fileno(), 65536)
    proc.send_signal(signal.SIGINT)
    out, _ = proc.communicate(timeout=900)
    out = seen + out
    assert proc.returncode == 0
    assert b"STATS" in out


def test_mesh_flag_oracle_parity(capsys, corpus_dir):
    # --mesh shards batch lanes over the whole (virtual) mesh; the output
    # must be identical to the single-device run
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    tmp, pat, data, patterns, corpus = corpus_dir
    outs = {}
    for extra in ([], ["--mesh", "all"], ["--mesh", "all", "--engine", "bloom"]):
        rc, out = run_cli(
            capsys,
            ["-f", data, "-p", pat, "-B", "128", "-G", "16", "-v", "-w", "1",
             "--sort"] + extra,
        )
        assert rc == 0
        outs[tuple(extra)] = sorted(
            l for l in out.splitlines() if l.startswith("Pattern")
        )
    vals = list(outs.values())
    assert vals[0] == vals[1] == vals[2]
    expect = sum(corpus.count(p) for p in patterns)
    assert len(vals[0]) == expect > 0


def test_dev_pos_selects_device(capsys, corpus_dir):
    # -D pins the session to the pos-th device (reference ocl_context.c:18-85)
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    tmp, pat, data, patterns, corpus = corpus_dir
    rc, out = run_cli(
        capsys, ["-f", data, "-p", pat, "-B", "256", "-G", "16", "-D", "1"]
    )
    assert rc == 0
    expect = sum(corpus.count(p) for p in patterns)
    assert f"Matches:             {expect}" in out
    # an out-of-range device position is a hard error
    with pytest.raises(SystemExit):
        main(["-f", data, "-p", pat, "-D", "99"])
    capsys.readouterr()


def test_verbose_relative_offset_and_context(capsys, tmp_path):
    # reference verbose format (ocl_aho_grep.c:284-303): the offset line
    # carries [relative: N] and is followed by a +-10-byte context window
    pat = tmp_path / "p.txt"
    pat.write_text("needle\n")
    data = tmp_path / "d.bin"
    data.write_bytes(b"0123456789abcdefneedleFEDCBA9876543210")
    rc, out = run_cli(
        capsys, ["-f", str(data), "-p", str(pat), "-v", "-B", "64", "-G", "16"]
    )
    assert rc == 0
    lines = out.splitlines()
    i = next(k for k, l in enumerate(lines) if l.startswith("Pattern"))
    assert "at offset 16 [relative: 16]" in lines[i]
    # window: 10 bytes before the match start .. 10 after its end
    assert lines[i + 1] == " ... 6789abcdefneedleFEDCBA9876 ... "


def test_verbose_context_stops_at_newline(capsys, tmp_path):
    pat = tmp_path / "p.txt"
    pat.write_text("needle\n")
    data = tmp_path / "d.bin"
    data.write_bytes(b"xxneedleyy\nTHE NEXT LINE")
    rc, out = run_cli(
        capsys, ["-f", str(data), "-p", str(pat), "-v", "-B", "64", "-G", "16"]
    )
    assert rc == 0
    lines = out.splitlines()
    i = next(k for k, l in enumerate(lines) if l.startswith("Pattern"))
    assert lines[i + 1] == " ... xxneedleyy ... "


def test_verbose_text_mode_echoes_line(capsys, tmp_path):
    pat = tmp_path / "p.txt"
    pat.write_text("needle\n")
    data = tmp_path / "d.txt"
    data.write_bytes(b"first line\nhay needle stack\nlast line\n")
    rc, out = run_cli(
        capsys,
        ["-f", str(data), "-p", str(pat), "-v", "-t", "-B", "64", "-G", "16"],
    )
    assert rc == 0
    lines = out.splitlines()
    i = next(k for k, l in enumerate(lines) if l.startswith("Pattern"))
    assert lines[i + 1] == "hay needle stack"


def test_overflow_warning_surfaced(capsys, tmp_path):
    # dense-engine slot overflow must warn with the exact lost count
    # (MATCHING.md's promise; the reference drops silently, ahomatch.cl:66)
    pat = tmp_path / "p.txt"
    pat.write_text("aa\n")
    data = tmp_path / "d.bin"
    data.write_bytes(b"a" * 64)  # 63 overlapping matches in one lane
    rc = main(["-f", str(data), "-p", str(pat), "-B", "64", "-G", "4",
               "-R", "4", "--engine", "dense"])
    captured = capsys.readouterr()
    assert rc == 0
    assert "WARNING: result slots overflowed" in captured.err
    assert "59 match(es) not reported" in captured.err  # 63 total, 4 slots


def test_check_args_value_rules(capsys, tmp_path):
    # reference check_args rules (ocl_aho_grep.c:210-267)
    pat = tmp_path / "p.txt"
    pat.write_text("x\n")
    data = tmp_path / "d.txt"
    data.write_bytes(b"x")
    for argv, msg in (
        (["-f", str(data), "-p", "/nope/missing.txt"], "does not exist"),
        (["-f", str(data), "-p", str(pat), "-w", "0"], "thread number"),
        (["-f", str(data), "-p", str(pat), "-m", "0"], "size limit"),
        (["-f", str(data), "-p", str(pat), "-m", "4096"], "<= 4095"),
        (["-f", str(data), "-p", str(pat), "-R", "0"], "result cells"),
    ):
        with pytest.raises(SystemExit) as ei:
            main(argv)
        assert ei.value.code == 2
        assert msg in capsys.readouterr().err


def test_profile_flag_writes_trace(capsys, corpus_dir, tmp_path):
    tmp, pat, data, patterns, corpus = corpus_dir
    tdir = tmp_path / "trace"
    rc, out = run_cli(
        capsys,
        ["-f", data, "-p", pat, "-B", "256", "-G", "16", "-w", "1",
         "--profile", str(tdir)],
    )
    assert rc == 0
    import os

    found = [
        os.path.join(r, f)
        for r, _, fs in os.walk(tdir)
        for f in fs
    ]
    assert found, "profiler trace directory is empty"


def test_save_load_bloom_filter(capsys, corpus_dir, tmp_path):
    # precompiled-filter cold start: --save-bloom then --load-bloom must
    # reproduce identical output without rebuilding the filter
    tmp, pat, data, patterns, corpus = corpus_dir
    bpath = str(tmp_path / "filter.npz")
    rc, out1 = run_cli(
        capsys,
        ["-f", data, "-p", pat, "-B", "128", "-G", "16", "-v", "-w", "1",
         "--engine", "bloom", "--sort", "--save-bloom", bpath],
    )
    assert rc == 0 and os.path.exists(bpath)
    rc, out2 = run_cli(
        capsys,
        ["-f", data, "-p", pat, "-B", "128", "-G", "16", "-v", "-w", "1",
         "--engine", "bloom", "--sort", "--load-bloom", bpath],
    )
    assert rc == 0
    p1 = sorted(l for l in out1.splitlines() if l.startswith("Pattern"))
    p2 = sorted(l for l in out2.splitlines() if l.startswith("Pattern"))
    assert p1 == p2 and len(p1) > 0


def test_global_sort_cross_engine_identical(capsys, tmp_path):
    """--sort semantics (MATCHING.md): per-batch canonical
    (file_id, end_offset) order, identical on every engine — the sorted
    verbose outputs of the dense and bloom engines over a MULTI-batch,
    multi-file stream must be byte-identical."""
    import numpy as np

    rng = np.random.RandomState(5)
    pat = tmp_path / "p.txt"
    pat.write_bytes(b"needle!\nhay\n")
    files = []
    for i in range(2):
        body = bytearray(rng.randint(97, 123, size=4000).astype(np.uint8))
        for pos in range(20 + i * 7, 3900, 177):
            body[pos : pos + 7] = b"needle!"
        for pos in range(60, 3900, 311):
            body[pos : pos + 3] = b"hay"
        f = tmp_path / f"in{i}.bin"
        f.write_bytes(bytes(body))
        files.append(str(f))
    # -w 1: one feeder worker => deterministic batch sequence (two
    # workers' batches interleave by thread timing, so two RUNS are not
    # comparable line-by-line regardless of engine; --sort specifies
    # order WITHIN a batch, MATCHING.md)
    argv = [
        "-f", ",".join(files), "-p", pat.as_posix(), "-v", "--sort",
        "-B", "64", "-G", "16", "-w", "1", "-R", "64",
    ]
    outs = {}
    for eng in ("dense", "bloom"):
        rc, out = run_cli(capsys, argv + ["--engine", eng])
        assert rc == 0
        outs[eng] = [
            ln for ln in out.splitlines() if ln.startswith("Pattern ")
        ]
    assert len(outs["dense"]) > 20  # multi-batch, match-bearing
    assert outs["dense"] == outs["bloom"]


def test_sort_global_cross_engine_identical_w2(capsys, tmp_path):
    """--sort-global: with TWO feeder workers,
    batches interleave by thread timing, so even per-batch-sorted output
    differs run to run; the consumer-side global merge on the canonical
    (file_id, end_offset) key makes the verbose output byte-identical
    across engines AND across runs at -w 2."""
    import numpy as np

    rng = np.random.RandomState(9)
    pat = tmp_path / "p.txt"
    pat.write_bytes(b"needle!\nhay\n")
    files = []
    for i in range(4):
        body = bytearray(rng.randint(97, 123, size=3000).astype(np.uint8))
        for pos in range(15 + i * 11, 2900, 191):
            body[pos : pos + 7] = b"needle!"
        for pos in range(60 + i * 3, 2900, 307):
            body[pos : pos + 3] = b"hay"
        f = tmp_path / f"in{i}.bin"
        f.write_bytes(bytes(body))
        files.append(str(f))
    argv = [
        "-f", ",".join(files), "-p", pat.as_posix(), "-v", "--sort-global",
        "-B", "64", "-G", "16", "-w", "2", "-R", "64",
    ]
    outs = {}
    for eng in ("dense", "bloom"):
        rc, out = run_cli(capsys, argv + ["--engine", eng])
        assert rc == 0
        outs[eng] = [
            ln for ln in out.splitlines() if ln.startswith("Pattern ")
        ]
    assert len(outs["dense"]) > 40
    assert outs["dense"] == outs["bloom"]
    # second bloom run, same flags: byte-identical despite -w 2 thread
    # timing (the property plain --sort cannot give)
    rc, out2 = run_cli(capsys, argv + ["--engine", "bloom"])
    assert [ln for ln in out2.splitlines()
            if ln.startswith("Pattern ")] == outs["bloom"]


def test_sort_global_rejects_follow(capsys, tmp_path):
    f = tmp_path / "in.txt"
    f.write_bytes(b"hello\n")
    pat = tmp_path / "p.txt"
    pat.write_bytes(b"hello\n")
    with pytest.raises(SystemExit):
        main(["-f", str(f), "-p", pat.as_posix(), "-v", "--sort-global",
              "-F"])
    assert "--sort-global" in capsys.readouterr().err
