"""Streaming sentiment analysis on multi-pattern match counts.

The application layer (reference apps/sentiment_analysis.py): negative words
get ids < 0, positive words ids > 0, a scored lexicon contributes weighted
ids; exponential time-decay counters per window {60s, 1h, 8h, 24h, 7d} track
the positive/negative balance and per-word heavy hitters.

Differences from the reference:
- runs on the LIBRARY API (MatchSession) instead of spawning the CLI and
  scraping its stdout (sentiment_analysis.py:188-199) — but a ``--subprocess``
  mode exercises the stdout protocol too, proving line compatibility;
- the match counting path is the psum workload of BASELINE config 5: device
  per-group counts, reduced across the mesh, expanded to per-pattern scores
  host-side.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time

import numpy as np


class TimeWindowCounter:
    """Exponentially decaying counter: c = value + e^(-ln2/halflife * dt) * c
    (reference sentiment_analysis.py:14-52)."""

    def __init__(self, halflife: float):
        self.halflife = halflife
        self.counter = 0.0
        self.timestamp: float | None = None

    def _decay(self, now: float) -> float:
        if self.timestamp is None:
            self.timestamp = now
        rate = math.log(2) / self.halflife
        return math.exp(-rate * (now - self.timestamp))

    def inc(self, value: float, now: float) -> None:
        self.counter = value + self._decay(now) * self.counter
        self.timestamp = now

    def update(self, now: float) -> float:
        self.counter = self._decay(now) * self.counter
        self.timestamp = now
        return self.counter

    def get(self) -> float:
        return self.counter


DEFAULT_WINDOWS = (60, 3600, 3600 * 8, 3600 * 24, 3600 * 24 * 7)


def build_sentiment_patterns(
    negative_path: str | None,
    positive_path: str | None,
    scored_path: str | None,
    out_path: str,
) -> dict[int, float]:
    """Write a categorical pattern file from word lists.

    Mirrors sentiment_analysis.py:66-127: negative ids count down from -1,
    positive up from +1; the scored lexicon (word, mean, std) contributes
    new words signed by mean and a metadata table {id: |mean|}. Words are
    wrapped in spaces (whole-word-ish matching), as in the reference's
    ``"\" word \""`` lines.
    """
    ids: dict[str, int] = {}
    meta: dict[int, float] = {}
    neg_id = 0
    pos_id = 0
    lines: list[str] = []

    def emit(word: str, pid: int) -> None:
        lines.append(f'{pid} " {word} "')

    if negative_path:
        with open(negative_path) as f:
            for line in f:
                w = line.strip()
                if not w:
                    continue
                neg_id -= 1
                ids[w] = neg_id
                emit(w, neg_id)
    if positive_path:
        with open(positive_path) as f:
            for line in f:
                w = line.strip()
                if not w:
                    continue
                pos_id += 1
                ids[w] = pos_id
                emit(w, pos_id)
    if scored_path:
        with open(scored_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) != 3:
                    continue
                w, mean, _std = parts[0], float(parts[1]), parts[2]
                if w in ids:
                    meta[ids[w]] = abs(mean)
                    continue
                if mean < 0:
                    neg_id -= 1
                    pid = neg_id
                else:
                    pos_id += 1
                    pid = pos_id
                ids[w] = pid
                meta[pid] = abs(mean)
                emit(w, pid)
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return meta


@dataclasses.dataclass
class SentimentReport:
    window: int
    score_pct: float | None
    top_words: list[tuple[str, float]]


class SentimentAnalyzer:
    """Decayed positive/negative counters + per-word heavy hitters."""

    def __init__(
        self,
        iids: list[int],
        labels: list[str],
        metadata: dict[int, float] | None = None,
        windows=DEFAULT_WINDOWS,
    ):
        self.windows = windows
        self.iids = iids
        self.labels = labels
        self.metadata = metadata or {}
        self.pos = {w: TimeWindowCounter(w) for w in windows}
        self.neg = {w: TimeWindowCounter(w) for w in windows}
        self.freq: dict[int, dict[int, TimeWindowCounter]] = {
            w: {} for w in windows
        }
        self.matches = 0

    def add_match(
        self, pattern_index: int, now: float | None = None, n: int = 1
    ) -> None:
        """Record ``n`` occurrences at one timestamp. The decayed counter
        is linear at a fixed timestamp (n increments of s == one increment
        of n*s: decay applies once, then dt = 0), so the bulk form is
        CLOSED-FORM exact — the psum count workload feeds thousands of
        events per batch and must not loop Python per event."""
        now = time.time() if now is None else now
        iid = self.iids[pattern_index]
        score = self.metadata.get(iid, 1.0) * n
        self.matches += n
        for w in self.windows:
            if iid < 0:
                self.neg[w].inc(score, now)
                self.pos[w].update(now)
            else:
                self.pos[w].inc(score, now)
                self.neg[w].update(now)
            tab = self.freq[w]
            if pattern_index not in tab:
                tab[pattern_index] = TimeWindowCounter(w)
            tab[pattern_index].inc(score, now)

    def add_group_counts(
        self,
        group_counts: np.ndarray,
        group_lists: list[list[int]],
        now: float | None = None,
    ) -> None:
        """Bulk path: device/psum-reduced per-group counts -> counters.
        O(nonzero groups), not O(total events)."""
        now = time.time() if now is None else now
        gc = np.asarray(group_counts)
        for g in np.flatnonzero(gc):
            for pidx in group_lists[int(g)]:
                self.add_match(pidx, now, n=int(gc[g]))

    def report(self, now: float | None = None, top_k: int = 5):
        now = time.time() if now is None else now
        out = []
        for w in self.windows:
            p = self.pos[w].update(now)
            n = self.neg[w].update(now)
            score = 100.0 * p / (p + n) if (p > 0 or n > 0) else None
            tops = sorted(
                ((pi, c.update(now)) for pi, c in self.freq[w].items()),
                key=lambda kv: -kv[1],
            )[:top_k]
            out.append(
                SentimentReport(
                    window=w,
                    score_pct=score,
                    top_words=[(self.labels[pi], v) for pi, v in tops],
                )
            )
        return out


# --------------------------------------------------------------------------
# Drivers


def run_library_mode(args, metadata: dict[int, float] | None = None) -> int:
    """Sentiment over the library API (one process, device counts)."""
    from pattern_matching.core.dfa import AhoCorasick
    from pattern_matching.core.patterns import load_pattern_file
    from pattern_matching.runtime.session import MatchSession

    parsed = load_pattern_file(args.patterns)
    ac = AhoCorasick()
    for p in parsed:
        ac.add_pattern(p.data, iid=p.iid, label=p.label)
    table = ac.compile()
    sess = MatchSession(
        table, max_chunks=args.global_ws, chunk_len=args.chunk_size
    )
    ana = SentimentAnalyzer(
        iids=[p.iid for p in table.patterns],
        labels=[p.label.strip(' "') for p in table.patterns],
        metadata=metadata,
    )
    last_print = time.time()
    with open(args.input, "rb") as f:
        for bm in sess.scan_stream(f, text_mode=True):
            now = time.time()
            for ev in bm.events:
                for pidx in ev.pattern_indices:
                    ana.add_match(pidx, now)
            if now - last_print >= args.interval:
                print_reports(ana)
                last_print = now
    print_reports(ana)
    return 0


def run_subprocess_mode(args) -> int:
    """Reference-style: spawn the CLI and parse its verbose stdout
    (proves "Pattern <id> ..." line compatibility)."""
    import shlex
    import subprocess

    cmd = (
        f"{sys.executable} -m pattern_matching.cli -p {args.patterns} "
        f"-f {args.input} -B {args.chunk_size} -G {args.global_ws} -w 1 -t -v"
    )
    proc = subprocess.Popen(shlex.split(cmd), stdout=subprocess.PIPE)
    ana = SentimentAnalyzer(iids=[], labels=[])
    # iid-keyed counters (we don't have the table in this process)
    seen: dict[int, str] = {}

    def add(iid: int, label: str):
        if iid not in seen:
            seen[iid] = label
            ana.iids.append(iid)
            ana.labels.append(label)
        pidx = list(seen).index(iid)
        ana.add_match(pidx)

    assert proc.stdout is not None
    for raw in proc.stdout:
        line = raw.decode("utf-8", "replace")
        if line.startswith("Pattern"):
            toks = line.split()
            iid = int(toks[1].replace("#", ""))
            label = line.split("('")[1].split("')")[0]
            add(iid, label)
    proc.wait()
    print_reports(ana)
    return proc.returncode or 0


def run_stdin_mode(args) -> int:
    """Pipe filter (reference apps/sentiment_analysis2.py): read the
    matcher's verbose stdout from stdin, print a decayed running match count
    per line and final per-pattern frequencies.

    Usage: aho_grep ... -v | tpm-sentiment --stdin --patterns p.txt
    """
    cnt = TimeWindowCounter(60)
    nmatches = 0
    freqs: dict[str, int] = {}
    for line in sys.stdin:
        if line.startswith("Pattern"):
            nmatches += 1
            now = time.time()
            cnt.inc(1.0, now)
            print(nmatches, cnt.get())
            pid = line.split()[1]
            freqs[pid] = freqs.get(pid, 0) + 1
    print(freqs)
    return 0


def print_reports(ana: SentimentAnalyzer) -> None:
    now = time.time()
    stamp = time.strftime("%a, %d %B %Y %H:%M:%S")
    for rep in ana.report(now):
        head = f"{stamp} {round(now, 1)} {str(rep.window).rjust(8)} : "
        if rep.score_pct is None:
            print(head)
            continue
        tops = " ".join(
            f"{w.rjust(10)} ( {round(v, 1)} )" for w, v in rep.top_words
        )
        print(f"{head}Score:  {round(rep.score_pct, 1)} % --------[ {tops} ]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpm-sentiment")
    ap.add_argument("input", nargs="?", default="-")
    ap.add_argument("--patterns")
    ap.add_argument(
        "--stdin",
        action="store_true",
        help="pipe mode: parse matcher -v output from stdin "
        "(reference sentiment_analysis2.py)",
    )
    ap.add_argument("--chunk-size", dest="chunk_size", type=int, default=4096)
    ap.add_argument("--global-ws", dest="global_ws", type=int, default=8192)
    ap.add_argument("--interval", type=float, default=5.0)
    ap.add_argument(
        "--subprocess",
        action="store_true",
        help="reference-style stdout scraping of the CLI",
    )
    ap.add_argument("--build-patterns", nargs=3, metavar=("NEG", "POS", "SCORED"))
    args = ap.parse_args(argv)
    from pattern_matching.utils.common import enable_compile_cache

    enable_compile_cache()
    if args.stdin:
        return run_stdin_mode(args)
    if not args.patterns or args.input == "-":
        ap.error("--patterns and an input file are required outside --stdin")
    metadata = None
    if args.build_patterns:
        neg, pos, scored = args.build_patterns
        metadata = build_sentiment_patterns(
            neg or None, pos or None, scored or None, args.patterns
        )
    if args.subprocess:
        return run_subprocess_mode(args)
    return run_library_mode(args, metadata)


if __name__ == "__main__":
    sys.exit(main())
