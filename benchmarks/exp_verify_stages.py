"""Decompose the fused device-joint cost (probe + verify) stage by stage.

The device-joint metric (bench.py) runs probe + _verify_kernel in one jit,
and its time can exceed the modeled walk cost several-fold. This
experiment finds where the rest goes, with interleaved honest-K-loop arms that truncate the verify
pipeline after each stage (the ``stages`` bench hook in
ops/verify_device.py):

- ``probe``   — probe only (stage 0)
- ``cand``    — probe + candidate compaction        (stages=2)
- ``walk``    — probe + compaction + windowed walk  (stages=3)
- ``events``  — + event compaction                  (stages=4)
- ``full``    — + per-group counts                  (stages=5)

Adjacent differences are the per-stage marginal costs. Planted density
seeds real candidates so the walk has survivors to chase.

Usage: python benchmarks/exp_verify_stages.py [n_patterns] [density]
"""

from __future__ import annotations

import functools
import json
import sys
import time

import numpy as np


def main(n_patterns: int = 10_000, density: float = 0.0) -> None:
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, ".")
    from bench import build_workload


    from pattern_matching.ops.bloom import (
        BloomFilterTable,
        _hits_jit,
    )
    from pattern_matching.ops.verify_device import (
        _verify_kernel,
        next_cap,
    )
    from pattern_matching.utils.common import pad_halo

    table = build_workload(n_patterns)
    bft = BloomFilterTable.from_table(table, objective="joint")
    cfg = bft.cfg
    C, B0 = 4096, 4096
    halo = pad_halo(table.max_pat_len - 1, B0)
    B = B0 + (-(halo + B0)) % cfg.tile_rows
    T = halo + B
    size = C * B

    rng = np.random.RandomState(7)
    data_np = rng.randint(0, 256, size=(C, T)).astype(np.uint8)
    pats = [p.symbols for p in table.patterns]
    if density > 0:
        n_seed = max(1, int(size * density) // 12)
        lanes_s = rng.randint(0, C, size=n_seed)
        pos_s = rng.randint(halo, T - 12, size=n_seed)
        chosen = rng.randint(0, len(pats), size=n_seed)
        for k in range(12):
            data_np[lanes_s, pos_s + k] = [pats[c][k] for c in chosen]
    data = jax.device_put(data_np)
    bounds = jax.device_put(
        np.stack([np.full(C, halo, np.int32), np.full(C, T, np.int32)])
    )
    words = jax.device_put(bft.words)
    table_flat = jax.device_put(
        np.ascontiguousarray(table.goto_signed).reshape(-1)
    )
    state_gid = jax.device_put(table.state_gid.astype(np.int32))

    meta, _bits = _hits_jit(data, bounds, words, cfg=cfg)
    survivors = int(np.asarray(meta)[0])
    k_cand = next_cap(max(survivors, 1))

    def make_run(stages):
        @functools.partial(jax.jit, static_argnames=("K",))
        def rep(data, bounds, *, K):
            def body(acc, _):
                b2 = bounds.at[0, 0].add(acc & 1)
                total, bits = _hits_jit(data, b2, words, cfg=cfg)
                acc = acc + total[0]
                if stages > 0:
                    m, _p, gc = _verify_kernel(
                        table_flat, state_gid, data, b2, bits,
                        alphabet_size=table.alphabet_size,
                        stride=cfg.stride, q=cfg.q,
                        lmax=table.max_pat_len, halo=halo,
                        k_cand=k_cand, k_ev=k_cand,
                        num_groups=table.num_groups, stages=stages,
                    )
                    # consume only what the truncated pipeline computed
                    acc = acc + m[0] + m[2] + (gc[0] if stages >= 5 else 0)
                return acc, None

            acc, _ = jax.lax.scan(
                body, jnp.zeros((), jnp.int32), None, length=K
            )
            return acc

        return lambda K: int(rep(data, bounds, K=K))

    arms = {
        "probe": make_run(0),
        "cand": make_run(2),
        "walk": make_run(3),
        "events": make_run(4),
        "full": make_run(5),
    }
    K_LO, K_HI = 1, 9
    for run in arms.values():
        run(K_LO)
        run(K_HI)

    best = {name: {K_LO: float("inf"), K_HI: float("inf")} for name in arms}
    for _round in range(5):
        for name, run in arms.items():
            for K in (K_LO, K_HI):
                t0 = time.perf_counter()
                run(K)
                best[name][K] = min(best[name][K], time.perf_counter() - t0)

    out = {
        "metric": "verify_stages",
        "n_patterns": n_patterns,
        "density": density,
        "cfg": ("sampled" if cfg.sampled else "strided")
        + f"_q{cfg.q}s{cfg.stride}w{cfg.w}k{cfg.kbanks}v{cfg.v}",
        "survivors": survivors,
        "k_cand": k_cand,
        "batch_bytes": size,
    }
    prev = None
    for name in ("probe", "cand", "walk", "events", "full"):
        per = (best[name][K_HI] - best[name][K_LO]) / (K_HI - K_LO)
        out[f"{name}_s_per_batch"] = per
        if prev is not None:
            out[f"{name}_marginal_s"] = per - prev
        prev = per
    out["full_bytes_per_s"] = size / out["full_s_per_batch"]
    print(json.dumps(out))


if __name__ == "__main__":
    main(
        int(sys.argv[1]) if len(sys.argv) > 1 else 10_000,
        float(sys.argv[2]) if len(sys.argv) > 2 else 0.0,
    )
