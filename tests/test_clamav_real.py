"""Real ClamAV signature distribution (reference clamav_sample_sigs/).

The reference ships its benchmark signature sets as printable hex with
heavy shared prefixes (README:71-83); prefix sharing collapses the
distinct-gram count far below stride*n and shifts the bloom chooser's
(q, stride/w, k, v) choice — synthetic random sigs never exercise that.
Skipped when the reference checkout is absent.
"""

import os

import numpy as np
import pytest

CLAMAV = "/root/reference/clamav_sample_sigs"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(CLAMAV), reason="reference clamav sigs not present"
)


def _load(n, limit=-1):
    from pattern_matching.core.patterns import load_pattern_file

    parsed = load_pattern_file(
        os.path.join(CLAMAV, f"{n}.txt"), hex_pat=True, pat_size_limit=limit
    )
    return [p.data for p in parsed]


def test_chooser_on_real_2000_and_planted_parity():
    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.core.oracle_native import NativeOracle
    from pattern_matching.ops.bloom import BloomFilterTable
    from pattern_matching.runtime.session import MatchSession

    sigs = _load(2000)
    bft = BloomFilterTable.build(sigs)
    # shared prefixes: distinct grams well below the no-sharing count
    no_sharing = sum(
        min(max(bft.cfg.stride, 1), len(p) - bft.cfg.q + 1) for p in sigs
    ) if not bft.cfg.sampled else len(sigs)
    assert bft.n_grams <= no_sharing
    assert bft.fp_est < 1e-2

    rng = np.random.RandomState(9)
    data = bytearray(rng.randint(0, 256, size=1 << 15).astype(np.uint8))
    planted = 0
    for k in range(12):
        sig = sigs[rng.randint(len(sigs))]
        pos = rng.randint(0, len(data) - len(sig))
        data[pos : pos + len(sig)] = sig
        planted += 1
    data = bytes(data)
    sess = MatchSession(
        compile_patterns(sigs), max_chunks=8, chunk_len=4096, engine="bloom"
    )
    got = sess.find(data)
    want = NativeOracle(sigs).match_events(data)
    assert got == want
    assert len(got) >= planted // 2  # plants may overwrite each other


def test_real_15000_m12_truncation_builds():
    # the 15k set at -m 12 (the reference's README recipe): truncation
    # creates duplicate patterns; build + chooser must handle them
    from pattern_matching.ops.bloom import BloomFilterTable

    sigs = _load(15000, limit=12)
    assert all(len(s) <= 12 for s in sigs)
    bft = BloomFilterTable.build(sigs)
    assert bft.n_grams > 0
    # record-keeping: the chosen config is printed so bench logs capture it
    print("15k -m12 config:", bft.cfg, "grams:", bft.n_grams,
          "fp:", bft.fp_est)


def test_reference_word_fixtures_cli_parity(capsys):
    # the reference's own shipped fixture pairs (tests/ and tests/1)
    # through our CLI, offsets checked against the native oracle
    import io

    from pattern_matching.cli import main
    from pattern_matching.core.oracle_native import NativeOracle

    base = "/root/reference/tests"
    for pat, data in (
        (f"{base}/patterns.txt", f"{base}/input.txt"),
        (f"{base}/1/patterns.txt", f"{base}/1/input.txt"),
    ):
        rc = main(["-f", data, "-p", pat, "-B", "256", "-G", "64",
                   "-v", "-w", "1", "--sort"])
        out = capsys.readouterr().out
        assert rc == 0
        got = []
        for line in out.splitlines():
            if line.startswith("Pattern "):
                lbl = line.split("('")[1].split("')")[0]
                off = int(line.split("at offset ")[1].split(" ")[0])
                got.append((off, lbl))
        pats = [l.strip() for l in open(pat).read().splitlines() if l.strip()]
        corpus = open(data, "rb").read()
        offs, pids, _ = NativeOracle([p.encode() for p in pats]).match(corpus)
        want = sorted(
            (int(e) - len(pats[int(p)]) + 1, pats[int(p)])
            for e, p in zip(offs, pids)
        )
        assert sorted(got) == want
        assert len(got) > 0


def test_reference_stress_pattern_set_compiles():
    # tests/2: the reference's 130KB pattern-only stress set — the builder
    # and both engines must digest it and agree on a planted corpus
    import numpy as np

    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.core.oracle_native import NativeOracle
    from pattern_matching.runtime.session import MatchSession

    pats = [
        l.strip().encode()
        for l in open("/root/reference/tests/2/patterns.txt").read().splitlines()
        if l.strip()
    ]
    assert len(pats) > 1000
    table = compile_patterns(pats)
    rng = np.random.RandomState(3)
    data = bytearray(rng.randint(0, 256, size=1 << 14).astype(np.uint8))
    for i, pos in enumerate((10, 5000, 16000)):
        p = pats[(i * 977) % len(pats)]
        data[pos : pos + len(p)] = p
    data = bytes(data)
    want = NativeOracle(pats).match_events(data)
    for eng in ("dense", "bloom"):
        sess = MatchSession(table, max_chunks=8, chunk_len=2048,
                            engine=eng, max_results=64)
        assert sess.find(data) == want, eng


def test_reference_sentiment_wordlists_build():
    # the reference's REAL sentiment wordlists (patterns/sentiment/*):
    # negative/positive lists merge with the scored lexicon into the
    # categorical pattern file + weight metadata (sentiment_analysis.py
    # 66-127 role), both the decade file and the sysadmin.tsv variant
    import os
    import tempfile

    from pattern_matching.apps.sentiment import build_sentiment_patterns

    base = "/root/reference/patterns/sentiment"
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        out = f.name
    try:
        meta = build_sentiment_patterns(
            f"{base}/negative_words_en.txt",
            f"{base}/positive_words_en.txt",
            f"{base}/top-5000_2000decade.txt",
            out,
        )
        lines = open(out).read().splitlines()
        assert len(lines) > 8000 and len(meta) > 4000
        meta2 = build_sentiment_patterns(None, None,
                                         f"{base}/sysadmin.tsv", out)
        assert len(meta2) > 4000
    finally:
        os.unlink(out)
