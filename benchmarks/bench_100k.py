"""Large-pattern-set scale points (100k / 300k / 1M) on the device.

Same honest protocol as bench.py (K scans inside one jit, t(K_hi)-t(K_lo)).
The strided mode cannot hold stride x n grams at a usable fp past ~30k
patterns (k*v ceiling); winnowing-sampled mode is the large-set enabler.

Beyond throughput, each point reports what the scale curve must prove:
DFA + filter build time, peak RSS, the chooser's pick, that the FAST
dense window walker is bound (no silent sparse-oracle fallback at scale),
and a save/load roundtrip of the compiled artifacts.

Usage: python benchmarks/bench_100k.py [n_patterns]
"""
import functools
import json
import sys
import os
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    return -1.0


def main(n_patterns=100_000):
    import jax
    import jax.numpy as jnp


    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.engine import best_scan_total_fn
    from pattern_matching.ops.bloom import BloomFilterTable
    from pattern_matching.runtime.verify import Verifier

    rng = np.random.RandomState(42)
    pats = [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(n_patterns)]

    t0 = time.time()
    table = compile_patterns(pats)
    dfa_build_s = time.time() - t0
    t0 = time.time()
    # probe objective: this curve reports PROBE-only bytes/s, comparable
    # to the round-1/2 entries (the session default optimizes the joint
    # pipeline instead — bench.py reports that)
    bft = BloomFilterTable.from_table(table, objective="probe")
    filter_build_s = time.time() - t0
    scan_total, halo = best_scan_total_fn(
        table, 4096, 4096, engine="bloom", bloom_table=bft
    )
    cfg = bft.cfg

    # the exactness stage must bind the FAST walker at this scale (an
    # int32 table binds as a view: no extra RAM)
    verifier = Verifier(
        [p.symbols for p in table.patterns],
        q=cfg.q, max_pat_len=table.max_pat_len, dense_table=table,
    )
    dense_walker_bound = verifier._dense is not None

    # compiled-artifact roundtrip at scale (pickle-free flat format);
    # past ~500k patterns the npz compression of a multi-GB table costs
    # tens of minutes — skip it there (the 300k row covers the feature)
    import tempfile

    save_s = load_s = -1.0
    if n_patterns <= 500_000:
      with tempfile.TemporaryDirectory() as td:
          t0 = time.time()
          table.save(os.path.join(td, "dfa.npz"))
          bft.save(os.path.join(td, "bloom.npz"))
          save_s = time.time() - t0
          t0 = time.time()
          from pattern_matching.core.dfa import DfaTable

          t2 = DfaTable.load(os.path.join(td, "dfa.npz"))
          b2 = BloomFilterTable.load(os.path.join(td, "bloom.npz"))
          load_s = time.time() - t0
          assert t2.num_states == table.num_states
          assert b2.cfg == bft.cfg
          del t2, b2

    C, B = 4096, 4096
    B += (-(halo + B)) % cfg.tile_rows

    data = jax.device_put(rng.randint(0, 256, size=(C, halo + B)).astype(np.uint8))
    start_t = jax.device_put(np.full(C, halo, np.int32))
    end_t = jax.device_put(np.full(C, halo + B, np.int32))

    @functools.partial(jax.jit, static_argnames=("K",))
    def repeat(data, start_t, end_t, *, K):
        def body(acc, _):
            s = start_t + (acc & 1)
            return acc + scan_total(data, s, end_t), None
        acc, _ = jax.lax.scan(body, jnp.zeros((), jnp.int32), None, length=K)
        return acc

    def run(K):
        return int(repeat(data, start_t, end_t, K=K))

    K_LO, K_HI = 1, 9
    survivors = run(K_LO)
    run(K_HI)

    def best_time(K, n=5):
        best = float("inf")
        for _ in range(n):
            t = time.perf_counter()
            run(K)
            best = min(best, time.perf_counter() - t)
        return best

    per_scan = (best_time(K_HI) - best_time(K_LO)) / (K_HI - K_LO)
    print(json.dumps({
        "metric": f"scan_bytes_per_s_per_chip_{n_patterns//1000}k_patterns",
        "value": C * B / per_scan,
        "unit": "bytes/s",
        "config": {"mode": "sampled" if cfg.sampled else "strided",
                   "q": cfg.q, "w": cfg.w, "stride": cfg.stride,
                   "k": cfg.kbanks, "v": cfg.v, "grams": bft.n_grams,
                   "fp_est": bft.fp_est},
        "survivor_rate_per_byte": survivors / (C * B),
        "dfa_build_s": round(dfa_build_s, 1),
        "filter_build_s": round(filter_build_s, 1),
        "states": table.num_states,
        "table_mb": round(table.nbytes / 1e6, 1),
        "rss_mb": round(_rss_mb(), 1),
        "dense_walker_bound": dense_walker_bound,
        "artifact_save_s": round(save_s, 1),
        "artifact_load_s": round(load_s, 1),
    }))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 100_000)
