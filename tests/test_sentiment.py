"""Sentiment application tests."""

import math

import numpy as np
import pytest

from pattern_matching.apps.sentiment import (
    SentimentAnalyzer,
    TimeWindowCounter,
    build_sentiment_patterns,
    main as sentiment_main,
)


def test_time_window_counter_decay():
    c = TimeWindowCounter(halflife=10.0)
    c.inc(1.0, now=0.0)
    assert c.get() == 1.0
    # one halflife later: decayed to 0.5, plus a new increment of 1
    c.inc(1.0, now=10.0)
    assert math.isclose(c.get(), 1.5, rel_tol=1e-9)
    assert math.isclose(c.update(20.0), 0.75, rel_tol=1e-9)


def test_analyzer_score():
    ana = SentimentAnalyzer(iids=[-1, 2], labels=["bad", "good"])
    t = 1000.0
    ana.add_match(1, t)  # good
    ana.add_match(1, t)  # good
    ana.add_match(0, t)  # bad
    reps = ana.report(t)
    for rep in reps:
        assert rep.score_pct is not None
        assert math.isclose(rep.score_pct, 100.0 * 2 / 3, rel_tol=1e-6)
        assert rep.top_words[0][0] == "good"


def test_analyzer_metadata_weights():
    ana = SentimentAnalyzer(
        iids=[-1, 1], labels=["awful", "nice"], metadata={-1: 3.0, 1: 1.0}
    )
    t = 50.0
    ana.add_match(0, t)
    ana.add_match(1, t)
    rep = ana.report(t)[0]
    assert math.isclose(rep.score_pct, 100.0 * 1 / 4, rel_tol=1e-6)


def test_build_patterns_file(tmp_path):
    (tmp_path / "neg.txt").write_text("awful\nterrible\n")
    (tmp_path / "pos.txt").write_text("great\n")
    (tmp_path / "scored.txt").write_text("meh -0.5 0.1\ngreat 0.9 0.2\nbad x\n")
    out = tmp_path / "patterns.txt"
    meta = build_sentiment_patterns(
        str(tmp_path / "neg.txt"),
        str(tmp_path / "pos.txt"),
        str(tmp_path / "scored.txt"),
        str(out),
    )
    lines = out.read_text().splitlines()
    assert lines[0] == '-1 " awful "'
    assert lines[1] == '-2 " terrible "'
    assert lines[2] == '1 " great "'
    assert lines[3] == '-3 " meh "'  # from the scored lexicon, negative mean
    assert meta[1] == 0.9 and meta[-3] == 0.5
    # the file parses as categorical
    from pattern_matching.core.patterns import load_pattern_file

    parsed = load_pattern_file(str(out))
    assert [p.iid for p in parsed] == [-1, -2, 1, -3]
    assert parsed[0].data == b" awful "


def test_end_to_end_library_mode(tmp_path, capsys):
    (tmp_path / "neg.txt").write_text("bad\nawful\n")
    (tmp_path / "pos.txt").write_text("good\ngreat\n")
    pat = tmp_path / "patterns.txt"
    build_sentiment_patterns(
        str(tmp_path / "neg.txt"), str(tmp_path / "pos.txt"), None, str(pat)
    )
    inp = tmp_path / "tweets.txt"
    inp.write_text(
        "what a good day\nthis is awful really awful\ngreat and good stuff\n" * 5
    )
    rc = sentiment_main(
        [str(inp), "--patterns", str(pat), "--chunk-size", "128",
         "--global-ws", "32"]
    )
    out = capsys.readouterr().out
    assert rc == 0
    assert "Score:" in out
    # patterns are space-wrapped (" word ", as in the reference), so words
    # at line edges or followed by '\n' don't match: per repetition 'good'
    # matches twice (mid-line), 'awful' once, 'great' never (line start).
    # 10 pos vs 5 neg -> 66.7%
    assert "Score:  66.7 %" in out


def test_group_counts_path():
    ana = SentimentAnalyzer(iids=[-1, 1], labels=["bad", "good"])
    gc = np.asarray([2, 3])
    ana.add_group_counts(gc, [[0], [1]], now=10.0)
    rep = ana.report(10.0)[0]
    assert math.isclose(rep.score_pct, 60.0, rel_tol=1e-6)


def test_stdin_pipe_mode(capsys, monkeypatch):
    import io as _io

    lines = (
        "Pattern 5 ('x') found in file 'f' at offset 1 [end: 1]\n"
        "noise line\n"
        "Pattern -2 ('y') found in file 'f' at offset 9 [end: 9]\n"
        "Pattern 5 ('x') found in file 'f' at offset 12 [end: 12]\n"
    )
    monkeypatch.setattr("sys.stdin", _io.StringIO(lines))
    rc = sentiment_main(["--stdin"])
    out = capsys.readouterr().out
    assert rc == 0
    # running decayed count per match line + final frequency dict
    assert out.splitlines()[0].startswith("1 1.0")
    assert "{'5': 2, '-2': 1}" in out


def test_bulk_group_counts_equals_per_event():
    # the closed-form bulk update must equal n per-event updates at the
    # same timestamp exactly (linearity of the decayed counter at dt=0)
    from pattern_matching.apps.sentiment import SentimentAnalyzer

    iids = [-1, 2, 3]
    labels = ["bad", "good", "great"]
    meta = {-1: 1.5, 2: 2.0, 3: 0.5}
    groups = [[0], [1, 2], [2]]
    counts = np.asarray([3, 0, 1000])
    a = SentimentAnalyzer(iids, labels, meta)
    b = SentimentAnalyzer(iids, labels, meta)
    t = 1_000_000.0
    a.add_group_counts(counts, groups, now=t)
    for g, n in enumerate(counts):
        for _ in range(int(n)):
            for pidx in groups[g]:
                b.add_match(pidx, now=t)
    assert a.matches == b.matches == 1003
    for w in a.windows:
        assert a.pos[w].get() == pytest.approx(b.pos[w].get(), rel=1e-12)
        assert a.neg[w].get() == pytest.approx(b.neg[w].get(), rel=1e-12)
        for pidx in (0, 2):
            assert a.freq[w][pidx].get() == pytest.approx(
                b.freq[w][pidx].get(), rel=1e-12
            )
