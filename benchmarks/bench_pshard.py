"""Pattern-sharding A/B at scale: one saturated filter vs S shard filters.

Usage: python benchmarks/bench_pshard.py [n_patterns] [n_shards]
           [--count] [--events] [--mux-only]

Measures three interleaved arms on the real chip (honest K-loop protocol,
same-process round-robin):

- ``single``:  the scale-curve arm — ONE filter over all N patterns at
  the probe-objective chooser pick (what the 100k/300k/1M curve reports).
- ``sharded``: S per-shard filters probed in ONE jit with on-device OR
  (parallel/pshard.py) — the single-chip capacity mode.
- ``one_shard``: shard 0's filter alone — exactly the per-chip work of an
  S-chip ("pat", "data") mesh row, so its rate IS the projected
  throughput of S-way pattern-sharded hardware on the same batch (each
  chip probes its shard concurrently; the all_gather+OR of W x C x 4B
  bitmaps rides the interconnect and is not measured on one chip).

``--count`` adds the MEASURED (not projected) service point: the FULL per-chip pipeline of the ("pat","data") count mesh —
probe own shard + per-shard exact-gram refinement of the union bitmap +
windowed walk against the shard's OWN 1/S dense table + group counts —
time-multiplexed as S sequential shard steps in ONE jit on the one chip.
One deployed chip does exactly 1/S of that work (the bitmap
all_gather+OR rides the interconnect and is the only unmeasured term), so
``mux_count_per_chip_bytes_per_s = S * batch_bytes / T_mux`` is a
measured per-chip figure, directly comparable to the one_shard
probe-only projection.

``--events`` adds the EVENT-emitting sibling:
the PshardDeviceVerifier kernel chain — per-shard walk of the union
bitmap against each shard's OWN 1/S table emitting packed
(lane, end, state) tuples — time-multiplexed as S sequential shard
steps in ONE jit (same protocol as --count), plus the D2H fetch +
host-side cross-shard merge measured separately (transfer-bound;
the merge itself is host CPU). ``--mux-only`` skips the three probe
arms (reuses the recorded curve) so an events/count re-run only builds
the sharded filter + shard tables.

Prints one JSON line with all rates and the survivor totals.
"""

from __future__ import annotations

import functools
import json
import sys
import time

import numpy as np


def main(n_patterns: int = 300_000, n_shards: int = 8) -> None:
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, ".")


    from pattern_matching.ops.bloom import (
        BloomFilterTable,
        _hits_jit,
    )
    from pattern_matching.parallel.pshard import (
        ShardedBloom,
        _sharded_hits_jit,
    )
    from pattern_matching.utils.common import pad_halo

    rng = np.random.RandomState(42)
    pats = [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(n_patterns)]

    mux_only = "--mux-only" in sys.argv
    single_build_s = 0.0
    single = None
    if not mux_only:
        t0 = time.time()
        single = BloomFilterTable.build(pats, objective="probe")
        single_build_s = time.time() - t0
    t0 = time.time()
    sharded = ShardedBloom.build(pats, n_shards, objective="probe")
    sharded_build_s = time.time() - t0

    C, B0 = 4096, 4096
    halo = pad_halo(12 - 1, B0)
    drng = np.random.RandomState(7)

    def make_arm(words_dev, cfg, probe):
        B = B0 + (-(halo + B0)) % cfg.tile_rows
        data = jax.device_put(
            drng.randint(0, 256, size=(C, halo + B)).astype(np.uint8)
        )
        bounds = jax.device_put(
            np.stack([np.full(C, halo, np.int32),
                      np.full(C, halo + B, np.int32)])
        )

        @functools.partial(jax.jit, static_argnames=("K",))
        def repeat(data, bounds, *, K):
            def body(acc, _):
                b2 = bounds.at[0, 0].add(acc & 1)
                total, _bits = probe(data, b2)
                return acc + total[0], None

            acc, _ = jax.lax.scan(
                body, jnp.zeros((), jnp.int32), None, length=K
            )
            return acc

        def run(K):
            return int(repeat(data, bounds, K=K))

        return run, C * B

    out = {
        "metric": "pshard_ab",
        "n_patterns": n_patterns,
        "n_shards": n_shards,
        "sharded_cfg": _cfgtag(sharded.cfg),
        "shard_fp_est": sharded.fp_est[0],
        "single_build_s": round(single_build_s, 1),
        "sharded_build_s": round(sharded_build_s, 1),
    }
    if not mux_only:
        out["single_cfg"] = _cfgtag(single.cfg)
        out["single_fp_est"] = single.fp_est
        words1 = jax.device_put(single.words)
        run1, size1 = make_arm(
            words1, single.cfg,
            lambda d, b: _hits_jit(d, b, words1, cfg=single.cfg),
        )
        wordsS = jax.device_put(sharded.words)
        runS, sizeS = make_arm(
            wordsS, sharded.cfg,
            lambda d, b: _sharded_hits_jit(
                d, b, wordsS, cfg=sharded.cfg, n_shards=n_shards,
            ),
        )
        words0 = jax.device_put(np.ascontiguousarray(sharded.words[0]))
        run0, size0 = make_arm(
            words0, sharded.cfg,
            lambda d, b: _hits_jit(d, b, words0, cfg=sharded.cfg),
        )

        arms = {"single": (run1, size1), "sharded": (runS, sizeS),
                "one_shard": (run0, size0)}
        K_LO, K_HI = 1, 5
        surv = {}
        for name, (run, _s) in arms.items():
            surv[name] = run(K_LO)  # compile + survivor total at K=1
            run(K_HI)

        best = {name: {K_LO: float("inf"), K_HI: float("inf")}
                for name in arms}
        for _round in range(5):  # interleaved: contention hits all alike
            for name, (run, _s) in arms.items():
                for K in (K_LO, K_HI):
                    t0 = time.perf_counter()
                    run(K)
                    best[name][K] = min(
                        best[name][K], time.perf_counter() - t0
                    )
        for name, (_run, size) in arms.items():
            per = (best[name][K_HI] - best[name][K_LO]) / (K_HI - K_LO)
            out[f"{name}_bytes_per_s"] = size / per
            out[f"{name}_survivors_per_byte"] = surv[name] / size

    shard_tables = None
    if "--count" in sys.argv or "--events" in sys.argv:
        from pattern_matching.core.dfa import compile_patterns

        t0 = time.time()
        shard_tables = [
            compile_patterns([pats[i] for i in sharded.parts[s]])
            for s in range(n_shards)
        ]
        out["shard_tables_build_s"] = round(time.time() - t0, 1)
    if "--count" in sys.argv:
        try:
            out.update(
                mux_count_arm(jax, jnp, pats, sharded, C, B0, halo,
                              drng, shard_tables)
            )
        except Exception as e:
            out["mux_count_error"] = repr(e)[:300]
    if "--events" in sys.argv:
        try:
            out.update(
                mux_events_arm(jax, jnp, sharded, shard_tables, C, B0,
                               halo, drng)
            )
        except Exception as e:
            out["mux_events_error"] = repr(e)[:300]
    if "--split" in sys.argv:
        if shard_tables is None:
            from pattern_matching.core.dfa import compile_patterns

            t0 = time.time()
            shard_tables = [
                compile_patterns([pats[i] for i in sharded.parts[s]])
                for s in range(n_shards)
            ]
            out["shard_tables_build_s"] = round(time.time() - t0, 1)
        try:
            out.update(
                split_arm(jax, jnp, sharded, shard_tables, C, B0,
                          halo, drng)
            )
        except Exception as e:
            out["split_error"] = repr(e)[:300]
    print(json.dumps(out))


def mux_count_arm(jax, jnp, pats, sharded, C, B0, halo, drng,
                  shard_tables) -> dict:
    """The measured per-chip service point of the ("pat","data") count
    mesh: S x (probe + union refinement vs own gram set + windowed walk
    vs own 1/S table + group counts) in ONE jit, divided by S."""
    import functools

    from pattern_matching.ops.bloom import _hits_jit
    from pattern_matching.ops.exact_gram import tables_from_keys_common
    from pattern_matching.ops.verify_device import (
        MAX_DEVICE_CAND,
        _verify_kernel,
        next_cap,
    )
    from pattern_matching.parallel.pshard import pad_shard_tables

    S = sharded.n_shards
    cfg = sharded.cfg
    flat, gids, lmax, gmax = pad_shard_tables(shard_tables)
    table_flat = jax.device_put(flat)
    state_gid = jax.device_put(gids)
    xts = tables_from_keys_common(sharded.shard_gram_keys, cfg.q, bits=8)
    x0 = xts[0]
    exact_meta = (x0.dmax, x0.m, x0.c1, x0.c2,
                  min(t.n for t in xts), bool(cfg.fold_case),
                  x0.use_hi, x0.bits)
    exact_lo = jax.device_put(
        np.stack([t.lo.view(np.int32) for t in xts])
    )
    exact_hi = (
        jax.device_put(np.stack([t.hi.view(np.int32) for t in xts]))
        if x0.use_hi else None
    )
    wordsS = jax.device_put(sharded.words)

    B = B0 + (-(halo + B0)) % cfg.tile_rows
    size = C * B
    data = jax.device_put(
        drng.randint(0, 256, size=(C, halo + B)).astype(np.uint8)
    )
    bounds = jax.device_put(
        np.stack([np.full(C, halo, np.int32),
                  np.full(C, halo + B, np.int32)])
    )

    # the tables are jit ARGUMENTS (not closures): closed-over arrays
    # embed as HLO constants, and the 8-shard table set would make the
    # compiled module as large as the tables
    def make_mux(k_cand, k_walk):
        @functools.partial(jax.jit, static_argnames=("K",))
        def mux(table_flat, state_gid, exact_lo, exact_hi, wordsS,
                data, bounds, *, K):
            def body(acc, _):
                b2 = bounds.at[0, 0].add(acc & 1)
                union = None
                for s in range(S):
                    _t, bits = _hits_jit(
                        data, b2, wordsS[s], cfg=cfg)
                    union = bits if union is None else union | bits
                tot = jnp.zeros((), jnp.int32)
                flags = jnp.zeros((), jnp.int32)
                for s in range(S):
                    meta, _p, gc = _verify_kernel(
                        table_flat[s], state_gid[s], data, b2, union,
                        exact_lo[s],
                        exact_hi[s] if exact_hi is not None else None,
                        alphabet_size=256, stride=cfg.stride, q=cfg.q,
                        lmax=lmax, halo=halo, k_cand=k_cand,
                        k_ev=k_walk, num_groups=gmax,
                        exact_meta=exact_meta, k_walk=k_walk,
                    )
                    tot = tot + meta[0] + gc[0]
                    flags = flags | meta[3]
                return acc + tot, flags

            acc, flags = jax.lax.scan(
                body, jnp.zeros((), jnp.int32), None, length=K
            )
            return acc, flags[-1]

        return mux

    # size the caps from the union survivor count of THIS batch, then
    # confirm flags stay clean (retry 2x on refined-walk overflow)
    union_total = 0
    for s in range(S):
        t, _b = _hits_jit(data, bounds, wordsS[s], cfg=cfg)
        union_total += int(np.asarray(t)[0])  # upper bound (no dedupe)
    k_cand = next_cap(min(MAX_DEVICE_CAND, max(4096, union_total)))
    k_walk = next_cap(max(2048, union_total // (2 * S)))
    for _ in range(3):
        mux = make_mux(k_cand, k_walk)
        _acc, flags = mux(table_flat, state_gid, exact_lo, exact_hi,
                          wordsS, data, bounds, K=1)
        f = int(np.asarray(flags))
        if not f:
            break
        if f & (2 | 4):
            k_walk = next_cap(k_walk * 2)
        if f & 1:
            k_cand = next_cap(min(MAX_DEVICE_CAND, k_cand * 2))

    def run(K):
        acc, flags = mux(table_flat, state_gid, exact_lo, exact_hi,
                         wordsS, data, bounds, K=K)
        return int(acc) + int(np.asarray(flags)) * 0

    K_LO, K_HI = 1, 5
    run(K_LO)
    run(K_HI)
    best = {K_LO: float("inf"), K_HI: float("inf")}
    for _round in range(5):
        for K in (K_LO, K_HI):
            t0 = time.perf_counter()
            run(K)
            best[K] = min(best[K], time.perf_counter() - t0)
    per_mux = (best[K_HI] - best[K_LO]) / (K_HI - K_LO)
    return {
        "mux_count_flags": f,
        "mux_count_k_cand": k_cand,
        "mux_count_k_walk": k_walk,
        "mux_count_T_mux_s_per_batch": per_mux,
        # one deployed chip does 1/S of the multiplexed work; only the
        # bitmap all_gather+OR over the interconnect is unmeasured
        "mux_count_per_chip_bytes_per_s": S * size / per_mux,
        "mux_count_1chip_serial_bytes_per_s": size / per_mux,
    }


def mux_events_arm(jax, jnp, sharded, shard_tables, C, B0, halo,
                   drng) -> dict:
    """The EVENT-emitting per-shard walk
    (PshardDeviceVerifier's kernel chain — union bitmap refined by each
    shard's OWN gram set, walked against the shard's OWN 1/S table,
    packed (lane, end, state) tuples out), time-multiplexed as S
    sequential shard steps in ONE jit on the one chip. Two numbers:

    - device mux: honest K-loop (the accumulated scalar folds in the
      packed tuples so emission cannot be dead-code-eliminated);
      ``mux_events_per_chip_bytes_per_s = S * size / T`` is the measured
      per-chip service rate (bitmap all_gather+OR over the interconnect unmeasured,
      same term as the count arm).
    - decode: ONE dispatch fetching S x (meta, packed, gcounts) + the
      host cross-shard merge keyed on (lane, end) — wall-clocked
      separately; the packed D2H depends on the host link, so this term is
      an upper bound a local deployment undercuts.

    Matches are PLANTED at ~1e-4 density (random patterns never occur in
    random data, and an events path with zero events measures nothing).
    """
    import functools

    from pattern_matching.ops.bloom import _hits_jit
    from pattern_matching.ops.exact_gram import tables_from_keys_common
    from pattern_matching.ops.verify_device import (
        MAX_DEVICE_CAND,
        _verify_kernel,
        next_cap,
    )
    from pattern_matching.parallel.pshard import pad_shard_tables

    S = sharded.n_shards
    cfg = sharded.cfg
    flat, gids, lmax, gmax = pad_shard_tables(shard_tables)
    table_flat = jax.device_put(flat)
    state_gid = jax.device_put(gids)
    xts = tables_from_keys_common(sharded.shard_gram_keys, cfg.q, bits=8)
    x0 = xts[0]
    exact_meta = (x0.dmax, x0.m, x0.c1, x0.c2,
                  min(t.n for t in xts), bool(cfg.fold_case),
                  x0.use_hi, x0.bits)
    exact_lo = jax.device_put(
        np.stack([t.lo.view(np.int32) for t in xts])
    )
    exact_hi = (
        jax.device_put(np.stack([t.hi.view(np.int32) for t in xts]))
        if x0.use_hi else None
    )
    wordsS = jax.device_put(sharded.words)

    B = B0 + (-(halo + B0)) % cfg.tile_rows
    size = C * B
    data_np = drng.randint(0, 256, size=(C, halo + B)).astype(np.uint8)
    # plant ~1e-4 true-match density spread across shards
    pats_all = shard_tables  # per-shard tables hold the shard's patterns
    n_seed = max(32, int(size * 1e-4) // 12)
    for k in range(n_seed):
        t = pats_all[k % S]
        p = t.patterns[k % len(t.patterns)].symbols
        ln = int(drng.randint(0, C))
        pos = int(drng.randint(halo, halo + B - len(p)))
        data_np[ln, pos : pos + len(p)] = p
    data = jax.device_put(data_np)
    bounds = jax.device_put(
        np.stack([np.full(C, halo, np.int32),
                  np.full(C, halo + B, np.int32)])
    )

    # tables/words as jit ARGUMENTS, not closures (HLO-constant blow-up,
    # as in make_mux)
    def shard_verify(tf, sg, xlo, xhi, data, b2, union, s, k_cand,
                     k_walk):
        return _verify_kernel(
            tf[s], sg[s], data, b2, union,
            xlo[s],
            xhi[s] if xhi is not None else None,
            alphabet_size=256, stride=cfg.stride, q=cfg.q,
            lmax=lmax, halo=halo, k_cand=k_cand, k_ev=k_walk,
            num_groups=gmax, exact_meta=exact_meta, k_walk=k_walk,
        )

    def union_bits(wS, data, b2):
        union = None
        for s in range(S):
            _t, bits = _hits_jit(data, b2, wS[s], cfg=cfg)
            union = bits if union is None else union | bits
        return union

    def make_mux(k_cand, k_walk):
        @functools.partial(jax.jit, static_argnames=("K",))
        def mux(tf, sg, xlo, xhi, wS, data, bounds, *, K):
            def body(acc, _):
                b2 = bounds.at[0, 0].add(acc & 1)
                union = union_bits(wS, data, b2)
                tot = jnp.zeros((), jnp.int32)
                flags = jnp.zeros((), jnp.int32)
                for s in range(S):
                    meta, packed, _gc = shard_verify(
                        tf, sg, xlo, xhi, data, b2, union, s, k_cand,
                        k_walk
                    )
                    # fold the packed tuples into the carried scalar so
                    # the event emission stays in the compiled program
                    tot = tot + meta[0] + (jnp.sum(packed) & 1)
                    flags = flags | meta[3]
                return acc + tot, flags

            acc, flags = jax.lax.scan(
                body, jnp.zeros((), jnp.int32), None, length=K
            )
            return acc, flags[-1]

        return mux

    union_total = 0
    for s in range(S):
        t, _b = _hits_jit(data, bounds, wordsS[s], cfg=cfg)
        union_total += int(np.asarray(t)[0])
    k_cand = next_cap(min(MAX_DEVICE_CAND, max(4096, union_total)))
    k_walk = next_cap(max(2048, union_total // (2 * S)))
    for _ in range(3):
        mux = make_mux(k_cand, k_walk)
        _acc, flags = mux(table_flat, state_gid, exact_lo, exact_hi,
                          wordsS, data, bounds, K=1)
        f = int(np.asarray(flags))
        if not f:
            break
        if f & (2 | 4):
            k_walk = next_cap(k_walk * 2)
        if f & 1:
            k_cand = next_cap(min(MAX_DEVICE_CAND, k_cand * 2))

    def run(K):
        acc, _fl = mux(table_flat, state_gid, exact_lo, exact_hi,
                       wordsS, data, bounds, K=K)
        return int(acc)

    K_LO, K_HI = 1, 5
    run(K_LO)
    run(K_HI)
    best = {K_LO: float("inf"), K_HI: float("inf")}
    for _round in range(5):
        for K in (K_LO, K_HI):
            t0 = time.perf_counter()
            run(K)
            best[K] = min(best[K], time.perf_counter() - t0)
    per_mux = (best[K_HI] - best[K_LO]) / (K_HI - K_LO)

    # --- decode arm: one dispatch, fetch, cross-shard merge ---------------
    @jax.jit
    def one_shot(tf, sg, xlo, xhi, wS, data, bounds):
        union = union_bits(wS, data, bounds)
        return [shard_verify(tf, sg, xlo, xhi, data, bounds, union, s,
                             k_cand, k_walk)
                for s in range(S)]

    args8 = (table_flat, state_gid, exact_lo, exact_hi, wordsS)
    one_shot(*args8, data, bounds)  # compile
    best_decode = float("inf")
    merged_events = 0
    for _round in range(3):
        t0 = time.perf_counter()
        outs = one_shot(*args8, data, bounds)
        seen = {}
        for s, (meta_d, packed_d, _gc) in enumerate(outs):
            meta = np.asarray(meta_d)
            packed = np.asarray(packed_d)[:, : int(meta[1])]
            for ln, e, st in packed.T:
                seen.setdefault((int(ln), int(e)), set()).add(s)
        merged_events = len(seen)
        best_decode = min(best_decode, time.perf_counter() - t0)

    return {
        "mux_events_flags": f,
        "mux_events_k_cand": k_cand,
        "mux_events_k_walk": k_walk,
        "mux_events_T_mux_s_per_batch": per_mux,
        "mux_events_per_chip_bytes_per_s": S * size / per_mux,
        "mux_events_decode_s_per_batch_transfer_bound": best_decode,
        "mux_events_merged": merged_events,
    }


def split_arm(jax, jnp, sharded, shard_tables, C, B0, halo,
              drng) -> dict:
    """Compile-friendly measured service point of the ("pat","data")
    mesh (count AND events — the verify kernel is the same; the count
    path merely discards the packed tuples).

    The S-shards-muxed-in-one-jit arm (mux_count_arm/mux_events_arm) is
    the cleanest protocol but its 8x-unrolled program takes very long to
    compile at 300k scale. This arm measures the SAME per-chip work as two small
    separately-K-looped stages a deployed chip actually runs per batch:

    - probe its OWN shard's filter over its lane shard (the one_shard
      arm's kernel);
    - verify the UNION bitmap (precomputed once here; on hardware it
      arrives over the interconnect) against its OWN 1/S table with its OWN
      exact-gram refinement, emitting packed events + group counts.

    per_chip_bytes_per_s = size / (T_probe + T_verify). The bitmap
    all_gather+OR over the interconnect remains the one unmeasured term (same caveat
    as every pshard projection). The decode fetch + cross-shard merge is
    wall-clocked separately (transfer-bound).

    Matches are PLANTED at ~1e-4 density (pure-random data would leave
    the events path with nothing to emit).
    """
    import functools

    from pattern_matching.ops.bloom import _hits_jit
    from pattern_matching.ops.exact_gram import tables_from_keys_common
    from pattern_matching.ops.verify_device import (
        MAX_DEVICE_CAND,
        _verify_kernel,
        next_cap,
    )
    from pattern_matching.parallel.pshard import (
        _sharded_hits_jit,
        pad_shard_tables,
    )

    S = sharded.n_shards
    cfg = sharded.cfg
    flat, gids, lmax, gmax = pad_shard_tables(shard_tables)
    table0 = jax.device_put(np.ascontiguousarray(flat[0]))
    gid0 = jax.device_put(np.ascontiguousarray(gids[0]))
    xts = tables_from_keys_common(sharded.shard_gram_keys, cfg.q, bits=8)
    x0 = xts[0]
    exact_meta = (x0.dmax, x0.m, x0.c1, x0.c2,
                  min(t.n for t in xts), bool(cfg.fold_case),
                  x0.use_hi, x0.bits)
    exact_lo0 = jax.device_put(xts[0].lo.view(np.int32))
    exact_hi0 = (jax.device_put(xts[0].hi.view(np.int32))
                 if x0.use_hi else None)
    words0 = jax.device_put(np.ascontiguousarray(sharded.words[0]))
    wordsS = jax.device_put(sharded.words)

    B = B0 + (-(halo + B0)) % cfg.tile_rows
    size = C * B
    data_np = drng.randint(0, 256, size=(C, halo + B)).astype(np.uint8)
    n_seed = max(32, int(size * 1e-4) // 12)
    for k in range(n_seed):
        t = shard_tables[k % S]
        p = t.patterns[k % len(t.patterns)].symbols
        ln = int(drng.randint(0, C))
        pos = int(drng.randint(halo, halo + B - len(p)))
        data_np[ln, pos : pos + len(p)] = p
    data = jax.device_put(data_np)
    bounds = jax.device_put(
        np.stack([np.full(C, halo, np.int32),
                  np.full(C, halo + B, np.int32)])
    )

    # the union bitmap, computed once (on deployed hardware this is the
    # all_gather+OR over the interconnect; its cost is not measurable through one chip)
    u_total, union = _sharded_hits_jit(
        data, bounds, wordsS, cfg=cfg, n_shards=S)
    union = jax.device_put(np.asarray(union))
    union_total = int(np.asarray(u_total)[0])

    # ---- arm 1: own-shard probe (the one_shard kernel) --------------------
    @functools.partial(jax.jit, static_argnames=("K",))
    def probe_rep(data, bounds, *, K):
        def body(acc, _):
            b2 = bounds.at[0, 0].add(acc & 1)
            total, _bits = _hits_jit(data, b2, words0, cfg=cfg)
            return acc + total[0], None

        acc, _ = jax.lax.scan(body, jnp.zeros((), jnp.int32), None,
                              length=K)
        return acc

    # ---- arm 2: own-table verify of the union bitmap ----------------------
    # NOTE the table/gram planes are jit ARGUMENTS, not closures: a
    # closed-over concrete array embeds as an HLO constant, and at 300k
    # scale the compiled module would carry every table
    def make_ver(k_cand, k_walk):
        @functools.partial(jax.jit, static_argnames=("K",))
        def ver_rep(table0, gid0, exact_lo0, exact_hi0, data, bounds,
                    union, *, K):
            def body(acc, _):
                b2 = bounds.at[0, 0].add(acc & 1)
                meta, packed, gc = _verify_kernel(
                    table0, gid0, data, b2, union, exact_lo0, exact_hi0,
                    alphabet_size=256, stride=cfg.stride, q=cfg.q,
                    lmax=lmax, halo=halo, k_cand=k_cand, k_ev=k_walk,
                    num_groups=gmax, exact_meta=exact_meta,
                    k_walk=k_walk,
                )
                return acc + meta[0] + gc[0] + (jnp.sum(packed) & 1), meta[3]

            acc, flags = jax.lax.scan(
                body, jnp.zeros((), jnp.int32), None, length=K
            )
            return acc, flags[-1]

        return ver_rep

    k_cand = next_cap(min(MAX_DEVICE_CAND, max(4096, union_total)))
    k_walk = next_cap(max(2048, union_total // (2 * S)))
    for _ in range(3):
        ver_rep = make_ver(k_cand, k_walk)
        _acc, flags = ver_rep(table0, gid0, exact_lo0, exact_hi0,
                              data, bounds, union, K=1)
        f = int(np.asarray(flags))
        if not f:
            break
        if f & (2 | 4):
            k_walk = next_cap(k_walk * 2)
        if f & 1:
            k_cand = next_cap(min(MAX_DEVICE_CAND, k_cand * 2))

    arms = {
        "probe": lambda K: int(probe_rep(data, bounds, K=K)),
        "verify": lambda K: int(ver_rep(table0, gid0, exact_lo0,
                                        exact_hi0, data, bounds, union,
                                        K=K)[0]),
    }
    K_LO, K_HI = 1, 5
    for run in arms.values():
        run(K_LO)
        run(K_HI)
    best = {name: {K_LO: float("inf"), K_HI: float("inf")}
            for name in arms}
    for _round in range(5):
        for name, run in arms.items():
            for K in (K_LO, K_HI):
                t0 = time.perf_counter()
                run(K)
                best[name][K] = min(best[name][K],
                                    time.perf_counter() - t0)
    per = {n: (best[n][K_HI] - best[n][K_LO]) / (K_HI - K_LO)
           for n in arms}

    # ---- decode: one verify dispatch, fetch, host merge against shard 0 ---
    ver_jit = jax.jit(
        lambda t0_, g0_, lo_, hi_, d, b, u: _verify_kernel(
            t0_, g0_, d, b, u, lo_, hi_,
            alphabet_size=256, stride=cfg.stride, q=cfg.q, lmax=lmax,
            halo=halo, k_cand=k_cand, k_ev=k_walk, num_groups=gmax,
            exact_meta=exact_meta, k_walk=k_walk,
        )
    )
    ver_jit(table0, gid0, exact_lo0, exact_hi0, data, bounds, union)
    best_decode = float("inf")
    n_shard0_events = 0
    for _round in range(3):
        t0 = time.perf_counter()
        meta_d, packed_d, _gc = ver_jit(table0, gid0, exact_lo0,
                                        exact_hi0, data, bounds, union)
        meta = np.asarray(meta_d)
        packed = np.asarray(packed_d)[:, : int(meta[1])]
        n_shard0_events = len({(int(a), int(b)) for a, b in packed[:2].T})
        best_decode = min(best_decode, time.perf_counter() - t0)

    return {
        "split_flags": f,
        "split_k_cand": k_cand,
        "split_k_walk": k_walk,
        "split_union_survivors": union_total,
        "split_probe_s_per_batch": per["probe"],
        "split_verify_s_per_batch": per["verify"],
        "split_per_chip_bytes_per_s": size / (per["probe"] + per["verify"]),
        "split_decode_s_per_batch_transfer_bound": best_decode,
        "split_shard0_events": n_shard0_events,
    }


def _cfgtag(cfg) -> str:
    return (("sampled" if cfg.sampled else "strided")
            + f"_q{cfg.q}s{cfg.stride}w{cfg.w}k{cfg.kbanks}v{cfg.v}")


if __name__ == "__main__":
    main(
        int(sys.argv[1]) if len(sys.argv) > 1 else 300_000,
        int(sys.argv[2]) if len(sys.argv) > 2 else 8,
    )
