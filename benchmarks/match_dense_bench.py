"""Match-dense end-to-end benchmark: probe + bitmap fetch + host verify.

The official bench (bench.py) times the device probe alone; on random data
(candidate rate <= 1e-3/byte) that is nearly the whole cost, but on
match-dense or adversarial input the decode pipeline — D2H bitmap fetch,
window merge, native verify — becomes the bottleneck. This bench plants a true gram at EVERY tested
position of a fraction of lanes and reports joint probe+fetch+verify
throughput at several densities, through the real MatchSession.scan_stream
pipeline (verify overlaps the next batch's device scan).

Usage: python benchmarks/match_dense_bench.py [--patterns N] [--mib M]
Prints one JSON line per density point.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--patterns", type=int, default=10_000)
    ap.add_argument("--mib", type=int, default=16)
    ap.add_argument("--engine", default="bloom")
    args = ap.parse_args()

    import io

    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.runtime.session import MatchSession

    rng = np.random.RandomState(42)
    pats = [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(args.patterns)]
    table = compile_patterns(pats)

    size = args.mib << 20
    base = rng.randint(0, 256, size=size).astype(np.uint8)

    # density = fraction of positions seeded with a planted pattern start;
    # 0 = the official random-data regime, higher = adversarial. Plants at
    # every 12-byte slot of the chosen fraction make every probe window a
    # true gram there (the bloom cannot reject true grams — worst case).
    for density in (0.0, 0.001, 0.01, 0.1, 1.0):
        data = base.copy()
        if density > 0:
            slots = size // 12
            n_seed = max(1, int(slots * density))
            idx = rng.choice(slots, size=n_seed, replace=False)
            chosen = rng.randint(0, len(pats), size=n_seed)
            pat_arr = np.stack([np.frombuffer(p, np.uint8) for p in pats])
            starts = idx * 12
            for k in range(12):
                data[starts + k] = pat_arr[chosen, k]
        payload = data.tobytes()

        sess = MatchSession(table, max_chunks=1024, chunk_len=4096,
                            engine=args.engine)

        def one_pass():
            # probe + fetch + verify with the vectorized count decode
            # (decode_counts) — the counting workload's real pipeline;
            # depth-2 so verify overlaps the next batch's device scan
            ev = 0
            buf = sess.new_buffer()
            from pattern_matching.runtime.buffers import StreamState

            stream = StreamState(file_id=0)
            fobj = io.BytesIO(payload)
            pending = []
            t0 = time.perf_counter()
            while True:
                code, rd = buf.add_stream(fobj, stream)
                eof = rd == 0
                if buf.chunks and (code == -1 or eof):
                    batch = buf.to_batch()
                    pending.append((batch, sess.scan(batch)))
                    if len(pending) > 1:
                        b, c = pending.pop(0)
                        n, _ = sess.decode_counts(b, c)
                        ev += n
                    buf = sess.new_buffer()
                if eof:
                    break
            for b, c in pending:
                n, _ = sess.decode_counts(b, c)
                ev += n
            return ev, time.perf_counter() - t0

        one_pass()  # compile + warm
        events, dt = one_pass()
        print(json.dumps({
            "metric": "match_dense_e2e_bytes_per_s",
            "density": density,
            "value": size / dt,
            "unit": "bytes/s",
            "events": events,
            "wall_s": round(dt, 3),
            "patterns": args.patterns,
            "engine": args.engine,
        }), flush=True)


if __name__ == "__main__":
    main()
