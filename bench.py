"""Benchmark: input bytes/s/chip at 10k patterns (the BASELINE north-star).

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "bytes/s", "vs_baseline": N}

The reference publishes no numbers (BASELINE.json "published": {}); its
protocol is bytes*8/wall Mbps on urandom corpora with ClamAV-style hex
signatures (SURVEY.md section 6). ``vs_baseline`` is therefore reported
against a nominal 1 GB/s/chip north-star denominator.

``value`` is the EXACT end-to-end number: the refined bloom pipeline
(device probe + on-device exact-gram refinement, host walks only the
true-gram residue) at 1e-3 planted match density, matches included — the
product, not the filter. The probe alone is reported under
``probe_only_bytes_per_s``.

Workload: 10,000 random hex signatures truncated to 12 bytes (the reference's
recommended ``-m 12`` for large ClamAV sets, README:71-83) scanned over
random binary.

Timing: the scan runs K times inside ONE jitted computation
(``lax.scan``), the host fetches the scalar total, and t(K_hi) - t(K_lo)
cancels fixed dispatch/transfer overhead. The run fails without a GPU:
a number from another backend is never reported under this metric.
"""

from __future__ import annotations

import functools
import json
import time

import numpy as np


def build_workload(n_patterns: int = 10_000, pat_len: int = 12, seed: int = 42):
    from pattern_matching.core.dfa import compile_patterns

    rng = np.random.RandomState(seed)
    pats = [bytes(rng.randint(0, 256, size=pat_len).astype(np.uint8))
            for _ in range(n_patterns)]
    return compile_patterns(pats)


def main() -> None:
    import jax
    import jax.numpy as jnp

    from pattern_matching.utils.common import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; found {dev.platform}")
    enable_compile_cache()

    from pattern_matching.engine import best_scan_total_fn
    from pattern_matching.ops.bloom import BloomFilterTable

    table = build_workload()
    C, B0 = 4096, 4096  # ~16 MiB payload per scan

    # primary metric: probe-only at the probe-optimal config — the same
    # definition rounds 1-2 reported, so the series stays comparable
    probe_bft = BloomFilterTable.from_table(table, objective="probe")
    scan_total, halo = best_scan_total_fn(
        table, C, B0, bloom_table=probe_bft
    )
    # align halo+B to the engine's row tiling so the device scans no
    # zero-padded rows (every row is real payload)
    B = B0 + (-(halo + B0)) % probe_bft.cfg.tile_rows

    rng = np.random.RandomState(7)
    data = jax.device_put(
        rng.randint(0, 256, size=(C, halo + B)).astype(np.uint8)
    )
    start_t = jax.device_put(np.full(C, halo, np.int32))
    end_t = jax.device_put(np.full(C, halo + B, np.int32))

    @functools.partial(jax.jit, static_argnames=("K",))
    def repeat(data, start_t, end_t, *, K):
        def body(acc, _):
            # thread the carry through an operand so XLA cannot hoist the
            # loop-invariant scan out of the loop (it will: verified)
            s = start_t + (acc & 1)
            return acc + scan_total(data, s, end_t), None

        acc, _ = jax.lax.scan(body, jnp.zeros((), jnp.int32), None, length=K)
        return acc

    def run(K):
        return int(repeat(data, start_t, end_t, K=K))

    K_LO, K_HI = 1, 9
    run(K_LO)
    run(K_HI)  # compile both

    def best_time(K, n=5):
        best = float("inf")
        for _ in range(n):
            t0 = time.perf_counter()
            run(K)
            best = min(best, time.perf_counter() - t0)
        return best

    per_scan = (best_time(K_HI) - best_time(K_LO)) / (K_HI - K_LO)
    probe_value = C * B / per_scan

    # joint metric: the WHOLE exactness
    # pipeline — probe + candidate compaction + windowed dense-table walk
    # + per-group counts — fused in one jit and K-looped, so the number
    # includes nothing for free. Measured at the
    # joint-objective chooser pick, on clean data and at 1e-3 planted
    # true-gram density; the host-verify arm's host-side cost per batch is
    # reported alongside (host work overlaps the next batch's scan in the
    # pipeline, so joint-throughput-with-host-verify is
    # bytes / max(probe_s, host_s) on a one-core-per-chip deployment).
    extra = joint_metrics(jax, jnp, table, C, B0, rng)

    # headline: the EXACT session-default pipeline with matches in the
    # data; probe-only remains a secondary series
    metric = "exact_refined_bytes_per_s_per_chip_10k_patterns"
    value = extra["refined_pipelined_bytes_per_s_d1e3"]

    from pattern_matching.ops.costmodel import get_cost_constants

    print(
        json.dumps(
            {
                "metric": metric,
                "value": value,
                "unit": "bytes/s",
                "vs_baseline": value / 1e9,
                "device": {"platform": dev.platform,
                           "kind": dev.device_kind,
                           "count": len(jax.devices())},
                # the reference publishes no numbers (BASELINE.json
                # "published": {}); the denominator is a nominal target,
                # labeled here so the ratio is not mistaken for a measured
                # reference figure
                "baseline_denominator": "nominal 1e9 bytes/s/chip (reference publishes no benchmark numbers)",
                # rounds 1-3 tracked probe-only as `value`; the series
                # continues here
                "probe_only_bytes_per_s": probe_value,
                # which chooser pricing this run used (ops/costmodel.py)
                "calibration": get_cost_constants().source,
                **extra,
            }
        )
    )


def joint_metrics(jax, jnp, table, C, B0, rng) -> dict:
    import functools
    import time

    from pattern_matching.ops.bloom import (
        BloomFilterTable,
        _hits_jit,
        unpack_hit_rows,
    )
    from pattern_matching.ops.verify_device import (
        _verify_kernel,
        next_cap,
    )
    from pattern_matching.runtime.verify import Verifier
    from pattern_matching.utils.common import pad_halo

    bft = BloomFilterTable.from_table(table, objective="joint")
    cfg = bft.cfg
    halo = pad_halo(table.max_pat_len - 1, B0)
    B = B0 + (-(halo + B0)) % cfg.tile_rows
    size = C * B
    words = jax.device_put(bft.words)
    table_flat = jax.device_put(
        np.ascontiguousarray(table.goto_signed).reshape(-1)
    )
    state_gid = jax.device_put(table.state_gid.astype(np.int32))
    verifier = Verifier(
        [p.symbols for p in table.patterns],
        q=cfg.q, max_pat_len=table.max_pat_len, dense_table=table,
    )
    pats = [p.symbols for p in table.patterns]
    out = {
        "joint_config": ("sampled" if cfg.sampled else "strided")
        + f"_q{cfg.q}s{cfg.stride}w{cfg.w}k{cfg.kbanks}v{cfg.v}",
    }
    start_np = np.full(C, halo, np.int32)
    end_np = np.full(C, halo + B, np.int32)
    for density, tag in ((0.0, "d0"), (1e-3, "d1e3")):
        data_np = rng.randint(0, 256, size=(C, halo + B)).astype(np.uint8)
        if density > 0:
            n_seed = max(1, int(size * density) // 12)
            lanes_s = rng.randint(0, C, size=n_seed)
            pos_s = rng.randint(halo, halo + B - 12, size=n_seed)
            chosen = rng.randint(0, len(pats), size=n_seed)
            for k in range(12):
                data_np[lanes_s, pos_s + k] = [
                    pats[c][k] for c in chosen
                ]
        data = jax.device_put(data_np)
        bounds = jax.device_put(np.stack([start_np, end_np]))
        meta, bits = _hits_jit(data, bounds, words, cfg=cfg)
        survivors = int(np.asarray(meta)[0])
        bits_np = np.asarray(bits)
        k_cand = next_cap(max(survivors, 1))

        @functools.partial(jax.jit, static_argnames=("K",))
        def joint(data, bounds, *, K, k_cand=k_cand):
            def body(acc, _):
                b2 = bounds.at[0, 0].add(acc & 1)
                total, bits = _hits_jit(data, b2, words, cfg=cfg)
                m, _p, gc = _verify_kernel(
                    table_flat, state_gid, data, b2, bits,
                    alphabet_size=table.alphabet_size, stride=cfg.stride,
                    q=cfg.q, lmax=table.max_pat_len, halo=halo,
                    k_cand=k_cand, k_ev=k_cand,
                    num_groups=table.num_groups,
                )
                return acc + total[0] + m[0] + gc[0], None

            acc, _ = jax.lax.scan(
                body, jnp.zeros((), jnp.int32), None, length=K
            )
            return acc

        def run(K):
            return int(joint(data, bounds, K=K))

        run(1)
        run(9)

        def best_time(K, n=4):
            b = float("inf")
            for _ in range(n):
                t0 = time.perf_counter()
                run(K)
                b = min(b, time.perf_counter() - t0)
            return b

        per = (best_time(9) - best_time(1)) / 8
        host = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            rows, lanes = unpack_hit_rows(bits_np, cfg.stride)
            verifier.verify_batch_arrays(
                data_np, lanes, rows, halo, start_np, end_np
            )
            host = min(host, time.perf_counter() - t0)
        out[f"joint_device_bytes_per_s_{tag}"] = size / per
        out[f"survivors_per_byte_{tag}"] = survivors / size
        out[f"host_verify_s_per_batch_{tag}"] = host
        out[f"probe_plus_host_pipelined_bytes_per_s_{tag}"] = None  # filled
    # the probe-only cost of the JOINT config (for the pipelined-host calc)
    @functools.partial(jax.jit, static_argnames=("K",))
    def probe_only(data, bounds, *, K):
        def body(acc, _):
            b2 = bounds.at[0, 0].add(acc & 1)
            total, _bits = _hits_jit(data, b2, words, cfg=cfg)
            return acc + total[0], None

        acc, _ = jax.lax.scan(
            body, jnp.zeros((), jnp.int32), None, length=K
        )
        return acc

    def prun(K):
        return int(probe_only(data, bounds, K=K))

    prun(1)
    prun(9)

    def pbest(K, n=4):
        b = float("inf")
        for _ in range(n):
            t0 = time.perf_counter()
            prun(K)
            b = min(b, time.perf_counter() - t0)
        return b

    probe_s = (pbest(9) - pbest(1)) / 8
    out["joint_probe_only_bytes_per_s"] = size / probe_s
    for tag in ("d0", "d1e3"):
        out[f"probe_plus_host_pipelined_bytes_per_s_{tag}"] = size / max(
            probe_s, out[f"host_verify_s_per_batch_{tag}"]
        )
    out.update(refined_metrics(jax, jnp, table, C, B0, rng))
    return out


def refined_metrics(jax, jnp, table, C, B0, rng) -> dict:
    """The session's DEFAULT single-chip pipeline: probe + on-device
    exact-gram refinement in one jit (the host walks only the true-gram
    residue — bloom fp never crosses the D2H), at the refined-objective
    chooser pick, k_ref sized exactly as MatchSession sizes it. Also the
    fully-on-device variant (refine + windowed walk + group counts in the
    same jit: the zero-host-CPU multi-chip count path)."""
    import functools
    import time

    from pattern_matching.ops.bloom import (
        REFINE_HEADROOM,
        BloomFilterTable,
        _hits_jit,
        _hits_refined_jit,
        unpack_hit_rows,
    )
    from pattern_matching.ops.exact_gram import table_from_keys
    from pattern_matching.ops.verify_device import (
        MAX_DEVICE_CAND,
        _verify_kernel,
        next_cap,
    )
    from pattern_matching.runtime.verify import Verifier
    from pattern_matching.utils.common import pad_halo

    bft = BloomFilterTable.from_table(table)  # default = refined objective
    cfg = bft.cfg
    halo = pad_halo(table.max_pat_len - 1, B0)
    B = B0 + (-(halo + B0)) % cfg.tile_rows
    size = C * B
    words = jax.device_put(bft.words)
    table_flat = jax.device_put(
        np.ascontiguousarray(table.goto_signed).reshape(-1)
    )
    state_gid = jax.device_put(table.state_gid.astype(np.int32))
    verifier = Verifier(
        [p.symbols for p in table.patterns],
        q=cfg.q, max_pat_len=table.max_pat_len, dense_table=table,
    )
    xt = table_from_keys(bft.gram_keys, cfg.q)
    exact_lo = jax.device_put(xt.lo.view(np.int32))
    exact_hi = jax.device_put(xt.hi.view(np.int32)) if xt.use_hi else None
    exact_meta = xt.device_meta(cfg.fold_case)
    k_ref = next_cap(int(min(
        MAX_DEVICE_CAND,
        max(2048, REFINE_HEADROOM * bft.expected_cand_rate() * size),
    )))
    out = {
        "refined_config": ("sampled" if cfg.sampled else "strided")
        + f"_q{cfg.q}s{cfg.stride}w{cfg.w}k{cfg.kbanks}v{cfg.v}",
        "refined_k_ref": k_ref,
    }
    pats = [p.symbols for p in table.patterns]
    start_np = np.full(C, halo, np.int32)
    end_np = np.full(C, halo + B, np.int32)

    def best_of(run, n=4, K_LO=1, K_HI=9):
        run(K_LO)
        run(K_HI)

        def bt(K):
            b = float("inf")
            for _ in range(n):
                t0 = time.perf_counter()
                run(K)
                b = min(b, time.perf_counter() - t0)
            return b

        return (bt(K_HI) - bt(K_LO)) / (K_HI - K_LO)

    for density, tag in ((0.0, "d0"), (1e-3, "d1e3")):
        data_np = rng.randint(0, 256, size=(C, halo + B)).astype(np.uint8)
        if density > 0:
            n_seed = max(1, int(size * density) // 12)
            lanes_s = rng.randint(0, C, size=n_seed)
            pos_s = rng.randint(halo, halo + B - 12, size=n_seed)
            chosen = rng.randint(0, len(pats), size=n_seed)
            for k in range(12):
                data_np[lanes_s, pos_s + k] = [pats[c][k] for c in chosen]
        data = jax.device_put(data_np)
        bounds = jax.device_put(np.stack([start_np, end_np]))

        @functools.partial(jax.jit, static_argnames=("K",))
        def refined_probe(data, bounds, *, K):
            def body(acc, _):
                b2 = bounds.at[0, 0].add(acc & 1)
                total, _bits = _hits_refined_jit(
                    data, b2, words, exact_lo, exact_hi, cfg=cfg,
                    exact_meta=exact_meta,
                    k_ref=k_ref,
                )
                return acc + total[0], None

            acc, _ = jax.lax.scan(body, jnp.zeros((), jnp.int32), None,
                                  length=K)
            return acc

        meta_r, bits_r = _hits_refined_jit(
            data, bounds, words, exact_lo, exact_hi, cfg=cfg,
            exact_meta=exact_meta, k_ref=k_ref,
        )
        n_refined = int(np.asarray(meta_r)[0])
        bits_r_np = np.asarray(bits_r)
        per = best_of(lambda K: int(refined_probe(data, bounds, K=K)))
        host = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            rows, lanes = unpack_hit_rows(bits_r_np, cfg.stride)
            verifier.verify_batch_arrays(
                data_np, lanes, rows, halo, start_np, end_np
            )
            host = min(host, time.perf_counter() - t0)
        out[f"refined_pipelined_bytes_per_s_{tag}"] = size / max(per, host)
        out[f"refined_residue_per_byte_{tag}"] = n_refined / size

        # fully-on-device: refine + windowed walk + group counts, one jit
        k_walk = next_cap(max(n_refined, 1))

        @functools.partial(jax.jit, static_argnames=("K",))
        def device_joint(data, bounds, *, K):
            def body(acc, _):
                b2 = bounds.at[0, 0].add(acc & 1)
                total, bits = _hits_jit(data, b2, words, cfg=cfg)
                m, _p, gc = _verify_kernel(
                    table_flat, state_gid, data, b2, bits,
                    exact_lo, exact_hi,
                    alphabet_size=table.alphabet_size, stride=cfg.stride,
                    q=cfg.q, lmax=table.max_pat_len, halo=halo,
                    k_cand=k_ref, k_ev=k_walk,
                    num_groups=table.num_groups,
                    exact_meta=exact_meta, k_walk=k_walk,
                )
                return acc + total[0] + m[0] + gc[0], None

            acc, _ = jax.lax.scan(body, jnp.zeros((), jnp.int32), None,
                                  length=K)
            return acc

        per_dj = best_of(lambda K: int(device_joint(data, bounds, K=K)))
        out[f"refined_device_joint_bytes_per_s_{tag}"] = size / per_dj
    return out


if __name__ == "__main__":
    main()
