"""Stage-level timing of the AC DFA build at scale.

Usage: python benchmarks/exp_build_profile.py [n_patterns]

Times compile_patterns end to end plus a cProfile top-30 by cumulative
time, to locate super-linear stages in the vectorized build (the 1M
point builds in ~2000 s while 300k takes 126 s — 16x for 3.3x patterns).
"""

from __future__ import annotations

import cProfile
import os
import pstats
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 300_000
    rng = np.random.RandomState(42)
    pats = [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(n)]

    from pattern_matching.core.dfa import compile_patterns

    t0 = time.perf_counter()
    prof = cProfile.Profile()
    prof.enable()
    table = compile_patterns(pats)
    prof.disable()
    dt = time.perf_counter() - t0
    print(f"n={n} states={table.goto_signed.shape[0]} total={dt:.1f}s")
    stats = pstats.Stats(prof)
    stats.sort_stats("cumulative").print_stats(30)


if __name__ == "__main__":
    main()
