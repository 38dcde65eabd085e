"""Interleaved A/B: device-verify walk with vs without window prefetch.

The windowed walk does two dependent gathers (table + data symbol) per
step. The prefetch variant replaces the WLp per-symbol data gathers with
ONE packed-uint32 word gather of WLp/4+1 words per candidate (a win where
gather cost is per gathered element, not per byte), leaving only the
data-dependent table-gather chain.

Arms interleave in-process (device contention), honest
K-loop (carry threaded through bounds so the body can't be hoisted),
best-of-rounds. Reported per arm: solo verify-kernel seconds/batch and
the fused probe+verify (device-joint) seconds, at the joint-objective
config's operating point (density 0) and at a candidate-heavy density.
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
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/root/.cache/jax_comp")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--patterns", type=int, default=10_000)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--densities", default="0,0.01")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.ops.bloom import (
        BloomFilterTable,
        _hits_jit,
    )
    from pattern_matching.ops.verify_device import (
        _verify_kernel,
        next_cap,
    )
    from pattern_matching.utils.common import pad_halo

    rng = np.random.RandomState(42)
    pats = [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(args.patterns)]
    table = compile_patterns(pats)
    bft = BloomFilterTable.from_table(table, objective="joint")
    cfg = bft.cfg
    C, B = 4096, 4096
    halo = pad_halo(table.max_pat_len - 1, B)
    B += (-(halo + B)) % cfg.tile_rows
    size = C * B
    words = jax.device_put(bft.words)
    table_flat = jax.device_put(
        np.ascontiguousarray(table.goto_signed).reshape(-1)
    )
    state_gid = jax.device_put(table.state_gid.astype(np.int32))

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

    for density in (float(d) for d in args.densities.split(",")):
        drng = np.random.RandomState(7)
        data_np = drng.randint(0, 256, size=(C, halo + B)).astype(np.uint8)
        if density > 0:
            n_seed = max(1, int(size * density) // 12)
            lanes_s = drng.randint(0, C, size=n_seed)
            pos_s = drng.randint(halo, halo + B - 12, size=n_seed)
            chosen = drng.randint(0, len(pats), size=n_seed)
            pat_arr = np.stack([np.frombuffer(p, np.uint8) for p in pats])
            for k in range(12):
                data_np[lanes_s, pos_s + k] = pat_arr[chosen, k]
        data = jax.device_put(data_np)
        bounds = jax.device_put(np.stack([
            np.full(C, halo, np.int32), np.full(C, halo + B, np.int32),
        ]))

        meta, bits = _hits_jit(data, bounds, words, cfg=cfg)
        survivors = int(np.asarray(meta)[0])
        k_cand = next_cap(max(survivors, 1))

        def make_solo(prefetch):
            @functools.partial(jax.jit, static_argnames=("K",))
            def solo(data, bounds, bits, *, K):
                def body(acc, _):
                    b2 = bounds.at[0, 0].add(acc & 1)
                    m, _p, gc = _verify_kernel(
                        table_flat, state_gid, data, b2, bits,
                        alphabet_size=table.alphabet_size,
                        stride=cfg.stride, q=cfg.q,
                        lmax=table.max_pat_len, halo=halo,
                        k_cand=k_cand, k_ev=k_cand,
                        num_groups=table.num_groups,
                        prefetch_windows=prefetch,
                    )
                    return acc + m[0] + gc[0], None

                acc, _ = jax.lax.scan(
                    body, jnp.zeros((), jnp.int32), None, length=K
                )
                return acc

            return solo

        def make_joint(prefetch):
            @functools.partial(jax.jit, static_argnames=("K",))
            def joint(data, bounds, *, K):
                def body(acc, _):
                    b2 = bounds.at[0, 0].add(acc & 1)
                    total, bb = _hits_jit(data, b2, words, cfg=cfg)
                    m, _p, gc = _verify_kernel(
                        table_flat, state_gid, data, b2, bb,
                        alphabet_size=table.alphabet_size,
                        stride=cfg.stride, q=cfg.q,
                        lmax=table.max_pat_len, halo=halo,
                        k_cand=k_cand, k_ev=k_cand,
                        num_groups=table.num_groups,
                        prefetch_windows=prefetch,
                    )
                    return acc + total[0] + m[0] + gc[0], None

                acc, _ = jax.lax.scan(
                    body, jnp.zeros((), jnp.int32), None, length=K
                )
                return acc

            return joint

        arms = {
            "prefetch": (make_solo("bitcast"), make_joint("bitcast")),
            "rowgather": (make_solo("rowgather"), make_joint("rowgather")),
            "per-symbol": (make_solo(False), make_joint(False)),
        }
        best = {k: [float("inf"), float("inf")] for k in arms}
        for _ in range(args.rounds):
            for name, (solo, joint) in arms.items():
                best[name][0] = min(
                    best[name][0],
                    timed(lambda K: int(solo(data, bounds, bits, K=K))),
                )
                best[name][1] = min(
                    best[name][1],
                    timed(lambda K: int(joint(data, bounds, K=K))),
                )

        out = {
            "metric": "walk_ab",
            "density": density,
            "survivors": survivors,
            "k_cand": k_cand,
            "bytes": size,
        }
        for name, (s, j) in best.items():
            key = name.replace("-", "_")
            out[f"solo_verify_s_{key}"] = s
            out[f"device_joint_s_{key}"] = j
            out[f"device_joint_bytes_per_s_{key}"] = size / j
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
