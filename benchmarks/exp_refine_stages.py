"""Stage decomposition of the refined-probe jit (_hits_refined_jit).

The refined-vs-joint A/B (exp_verify_ab.py) measured ~7.3 ms of refine
overhead per 17 MiB batch at k_ref=6144 — ~15x the exact_member gather
model (~6 gathers x 6k slots x 13 ns = 0.5 ms). This harness K-loops
successively deeper prefixes of the refined pipeline in one process
(interleaved, best-of-rounds) to locate the cost:

  probe      _hits_jit (baseline)
  btc1       + stage-1 word compaction (transpose, flags, cumsum, scatter)
  btc        + stage-2 bit expansion + compaction (full bitmap_to_candidates)
  gram       + q data gathers assembling the candidate gram keys
  member     + dmax exact-table gathers (full exact_member)
  refined    the shipped _hits_refined_jit (adds the scatter-back bitmap)

Each stage returns a scalar folded into the carry so nothing hoists.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--patterns", type=int, default=10_000)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--k-ref", type=int, default=0,
                    help="candidate capacity; 0 = next_cap(survivors)")
    ap.add_argument("--objective", default="joint")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.ops.bloom import (
        BloomFilterTable,
        _hits_jit,
        _hits_refined_jit,
        _probe_bits_jit,
    )
    from pattern_matching.ops.exact_gram import (
        DeviceExact,
        exact_member,
        table_from_keys,
    )
    from pattern_matching.ops.verify_device import (
        _compact_flags,
        bitmap_to_candidates,
        next_cap,
    )
    from pattern_matching.utils.common import pad_halo

    rng = np.random.RandomState(42)
    pats = [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(args.patterns)]
    table = compile_patterns(pats)
    bft = BloomFilterTable.from_table(table, objective=args.objective)
    cfg = bft.cfg
    C, B = 4096, 4096
    halo = pad_halo(table.max_pat_len - 1, B)
    B += (-(halo + B)) % cfg.tile_rows
    size = C * B
    words = jax.device_put(bft.words)

    drng = np.random.RandomState(7)
    data_np = drng.randint(0, 256, size=(C, halo + B)).astype(np.uint8)
    data = jax.device_put(data_np)
    bounds = jax.device_put(
        np.stack([np.full(C, halo, np.int32), np.full(C, halo + B, np.int32)])
    )

    meta, bits0 = _hits_jit(data, bounds, words, cfg=cfg)
    survivors = int(np.asarray(meta)[0])
    k_ref = args.k_ref or next_cap(max(survivors, 1))

    xt = table_from_keys(bft.gram_keys, cfg.q)
    exact_lo = jax.device_put(xt.lo.view(np.int32))
    exact_hi = jax.device_put(xt.hi.view(np.int32)) if xt.use_hi else None
    exact_meta = xt.device_meta(cfg.fold_case)

    def probe_bits(data, b2):
        return _probe_bits_jit(data, b2, words, cfg=cfg)

    def stage_probe(data, b2):
        bits = probe_bits(data, b2)
        return jnp.sum(jax.lax.population_count(bits))

    def stage_btc1(data, b2):
        bits = probe_bits(data, b2)
        W, Cb = bits.shape
        wordsT = bits.T
        n_words, (widx, wval), _ = _compact_flags(
            (wordsT != 0).reshape(-1),
            [
                (jax.lax.broadcasted_iota(
                    jnp.int32, (Cb * W, 1), 0).squeeze(-1),
                 jnp.int32(Cb * W)),
                (wordsT.reshape(-1), jnp.int32(0)),
            ],
            k_ref,
        )
        return n_words + widx[0] + wval[0]

    def stage_btc(data, b2):
        bits = probe_bits(data, b2)
        n_cand, lane, row, over = bitmap_to_candidates(bits, cfg.stride,
                                                       k_ref)
        return n_cand + lane[0] + row[0]

    def _grams(data, bits):
        Cd, T = data.shape
        n_cand, lane, row, over = bitmap_to_candidates(bits, cfg.stride,
                                                       k_ref)
        base = jnp.minimum(lane, Cd - 1) * T + jnp.minimum(row, T - 1)
        slotv = (
            jax.lax.broadcasted_iota(jnp.int32, (k_ref, 1), 0).squeeze(-1)
            < n_cand
        )
        return base, slotv, n_cand

    def stage_gram(data, b2):
        bits = probe_bits(data, b2)
        base, slotv, n_cand = _grams(data, bits)
        flat = data.reshape(-1)
        lo = jnp.zeros((k_ref,), jnp.int32)
        for i in range(cfg.q):
            s = jnp.take(flat, jnp.clip(base + i, 0, flat.shape[0] - 1),
                         mode="clip").astype(jnp.int32)
            lo = lo | jax.lax.shift_left(s, jnp.int32(8 * (i % 4)))
        return n_cand + jnp.sum(lo & 1)

    def stage_member(data, b2):
        bits = probe_bits(data, b2)
        base, slotv, n_cand = _grams(data, bits)
        dx = DeviceExact.from_meta(exact_lo, exact_hi, cfg.q,
                                   True, exact_meta)
        keep = exact_member(dx, data.reshape(-1), base, slotv)
        return n_cand + jnp.sum(keep.astype(jnp.int32))

    def stage_refined(data, b2):
        total, _bits = _hits_refined_jit(
            data, b2, words, exact_lo, exact_hi, cfg=cfg,
            exact_meta=exact_meta, k_ref=k_ref,
        )
        return total[0]

    stages = [
        ("probe", stage_probe),
        ("btc1", stage_btc1),
        ("btc", stage_btc),
        ("gram", stage_gram),
        ("member", stage_member),
        ("refined", stage_refined),
    ]

    def kloop(fn):
        @functools.partial(jax.jit, static_argnames=("K",))
        def run(data, bounds, *, K):
            def body(acc, _):
                b2 = bounds.at[0, 0].add(acc & 1)
                return acc + fn(data, b2), None

            acc, _ = jax.lax.scan(body, jnp.zeros((), jnp.int32), None,
                                  length=K)
            return acc

        return run

    jits = [(name, kloop(fn)) for name, fn in stages]

    def timed(fn, K_LO=1, K_HI=9, n=3):
        fn(K_LO)
        fn(K_HI)

        def best(K):
            b = float("inf")
            for _ in range(n):
                t0 = time.perf_counter()
                fn(K)
                b = min(b, time.perf_counter() - t0)
            return b

        return (best(K_HI) - best(K_LO)) / (K_HI - K_LO)

    best = {name: float("inf") for name, _ in jits}
    for _ in range(args.rounds):
        for name, run in jits:
            best[name] = min(
                best[name],
                timed(lambda K, run=run: int(run(data, bounds, K=K))),
            )

    out = {
        "metric": "refine_stages",
        "cfg": f"q{cfg.q}s{cfg.stride}w{cfg.w}k{cfg.kbanks}v{cfg.v}"
               + ("sampled" if cfg.sampled else ""),
        "bytes": size,
        "survivors": survivors,
        "k_ref": k_ref,
        "dmax": xt.dmax,
        "m": xt.m,
    }
    prev = 0.0
    for name, _ in jits:
        out[f"{name}_s"] = best[name]
        out[f"{name}_marginal_ms"] = (best[name] - prev) * 1e3
        prev = best[name]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
