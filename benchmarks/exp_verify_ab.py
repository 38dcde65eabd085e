"""Interleaved A/B: host verify vs device verify on the flagship engine.

Arms, at the official 10k x 12B point and planted true-gram densities:

- **device**: probe + device verify + per-group counts fused in ONE jit,
  K-looped with the honest protocol (carry threaded through an operand,
  scalar fetched, t(K_hi)-t(K_lo)) — a transfer-independent joint
  number for the whole exactness pipeline.
- **host**: the probe K-loop (device seconds) plus the host-side
  decode+verify cost measured directly on a prefetched bitmap (host numpy
  work: no transfer in the loop). The pipelined joint throughput of this arm
  is bytes / max(device_s, host_s) since decode overlaps the next batch's
  scan (scan_stream depth>=2), PLUS the bitmap D2H (reported as bytes —
  transfer cost is deployment-specific).

Arms interleave within one process round-robin (device contention swings
sequential runs), best-of-rounds per arm.
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
    ap.add_argument("--densities", default="0,0.001,0.01")
    ap.add_argument("--force", default="",
                    help="force filter configs: 'q,s,k,v[;...]' (strided) "
                    "or 'S:q,w,k,v' (sampled) — sweep vs the chooser pick")
    ap.add_argument("--mode", default="auto")
    ap.add_argument("--objective", default="joint",
                    help="chooser objective for the 'auto' variant")
    ap.add_argument("--objective2", default="",
                    help="add a second auto variant under this objective "
                    "(e.g. 'refined') — interleaved against the first")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.ops.bloom import (
        BloomFilterTable,
        _hits_jit,
        _hits_refined_jit,
        unpack_hit_rows,
    )
    from pattern_matching.ops.exact_gram import table_from_keys
    from pattern_matching.ops.verify_device import (
        _verify_kernel,
        next_cap,
    )
    from pattern_matching.runtime.verify import Verifier
    from pattern_matching.utils.common import pad_halo

    rng = np.random.RandomState(42)
    pats = [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(args.patterns)]
    table = compile_patterns(pats)
    variants = [(
        f"auto-{args.objective}",
        BloomFilterTable.from_table(
            table, mode=args.mode, objective=args.objective
        ),
    )]
    if args.objective2:
        variants.append((
            f"auto-{args.objective2}",
            BloomFilterTable.from_table(
                table, mode=args.mode, objective=args.objective2
            ),
        ))
    for spec in (s for s in args.force.split(";") if s):
        fmode = "strided"
        if spec.startswith("S:"):
            fmode, spec = "sampled", spec[2:]
        q, s, k, v = (int(x) for x in spec.split(","))
        variants.append((
            f"{fmode[:1]}q{q}{'w' if fmode == 'sampled' else 's'}{s}k{k}v{v}",
            BloomFilterTable.from_table(table, force=(fmode, q, s, k, v)),
        ))
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

    work = []
    for tag, bft in variants:
        cfg = bft.cfg
        C, B = 4096, 4096
        halo = pad_halo(table.max_pat_len - 1, B)
        B += (-(halo + B)) % cfg.tile_rows
        words = jax.device_put(bft.words)
        verifier = Verifier(
            [p.symbols for p in table.patterns],
            q=cfg.q, max_pat_len=table.max_pat_len, dense_table=table,
        )
        for density in (float(d) for d in args.densities.split(",")):
            work.append((tag, bft, cfg, C, B, halo, words, verifier,
                         density))

    for (tag, bft, cfg, C, B, halo, words, verifier, density) in work:
        size = C * B
        drng = np.random.RandomState(7)
        data_np = drng.randint(0, 256, size=(C, halo + B)).astype(np.uint8)
        start_np = np.full(C, halo, np.int32)
        end_np = np.full(C, halo + B, np.int32)
        if density > 0:
            n_seed = max(1, int(size * density) // 12)
            lanes_s = drng.randint(0, C, size=n_seed)
            pos_s = drng.randint(halo, halo + B - 12, size=n_seed)
            chosen = drng.randint(0, len(pats), size=n_seed)
            pat_arr = np.stack([np.frombuffer(p, np.uint8) for p in pats])
            for k in range(12):
                data_np[lanes_s, pos_s + k] = pat_arr[chosen, k]
        data = jax.device_put(data_np)
        bounds = jax.device_put(np.stack([start_np, end_np]))

        # survivors at this density -> bucketed device capacities
        meta, bits = _hits_jit(data, bounds, words, cfg=cfg)
        survivors = int(np.asarray(meta)[0])
        bits_np = np.asarray(bits)
        k_cand = next_cap(max(survivors, 1))
        k_ev = k_cand

        # refined arm: exact-gram table + post-refinement capacity from a
        # probe dispatch (the session's own protocol)
        xt = table_from_keys(bft.gram_keys, cfg.q)
        exact_lo = jax.device_put(xt.lo.view(np.int32))
        exact_hi = (jax.device_put(xt.hi.view(np.int32))
                    if xt.use_hi else None)
        exact_meta = xt.device_meta(cfg.fold_case)
        m0, _p0, _g0 = _verify_kernel(
            table_flat, state_gid, data, bounds, bits,
            exact_lo, exact_hi,
            alphabet_size=table.alphabet_size, stride=cfg.stride,
            q=cfg.q, lmax=table.max_pat_len, halo=halo,
            k_cand=k_cand, k_ev=k_ev, num_groups=table.num_groups,
            exact_meta=exact_meta, k_walk=k_cand,
        )
        n_exact = int(np.asarray(m0)[4])
        k_walk = next_cap(max(n_exact, 1))

        @functools.partial(jax.jit, static_argnames=("K",))
        def device_arm(data, bounds, *, K):
            def body(acc, _):
                b2 = bounds.at[0, 0].add(acc & 1)  # thread the carry
                total, bits = _hits_jit(data, b2, words, cfg=cfg)
                m, _p, gc = _verify_kernel(
                    table_flat, state_gid, data, b2, bits,
                    alphabet_size=table.alphabet_size, stride=cfg.stride,
                    q=cfg.q, lmax=table.max_pat_len, halo=halo,
                    k_cand=k_cand, k_ev=k_ev,
                    num_groups=table.num_groups,
                )
                return acc + total[0] + m[0] + gc[0], None

            acc, _ = jax.lax.scan(
                body, jnp.zeros((), jnp.int32), None, length=K
            )
            return acc

        @functools.partial(jax.jit, static_argnames=("K",))
        def refined_arm(data, bounds, *, K):
            def body(acc, _):
                b2 = bounds.at[0, 0].add(acc & 1)  # thread the carry
                total, bits = _hits_jit(data, b2, words, cfg=cfg)
                m, _p, gc = _verify_kernel(
                    table_flat, state_gid, data, b2, bits,
                    exact_lo, exact_hi,
                    alphabet_size=table.alphabet_size, stride=cfg.stride,
                    q=cfg.q, lmax=table.max_pat_len, halo=halo,
                    k_cand=k_cand, k_ev=k_walk,
                    num_groups=table.num_groups,
                    exact_meta=exact_meta, k_walk=k_walk,
                )
                return acc + total[0] + m[0] + gc[0], None

            acc, _ = jax.lax.scan(
                body, jnp.zeros((), jnp.int32), None, length=K
            )
            return acc

        # refined HOST pipeline: the device pays probe + exact-gram
        # refinement (one jit, no walk); the host fetches a bitmap holding
        # only true-gram candidates and walks just those. This is the
        # session's single-chip default path when refinement is attached,
        # and the arm that calibrates REFINE_NS_PER_CAND in the chooser.
        @functools.partial(jax.jit, static_argnames=("K",))
        def refined_probe_arm(data, bounds, *, K):
            def body(acc, _):
                b2 = bounds.at[0, 0].add(acc & 1)
                total, _bits = _hits_refined_jit(
                    data, b2, words, exact_lo, exact_hi, cfg=cfg,
                    exact_meta=exact_meta,
                    k_ref=k_cand,
                )
                return acc + total[0], None

            acc, _ = jax.lax.scan(
                body, jnp.zeros((), jnp.int32), None, length=K
            )
            return acc

        meta_r, bits_r = _hits_refined_jit(
            data, bounds, words, exact_lo, exact_hi, cfg=cfg,
            exact_meta=exact_meta, k_ref=k_cand,
        )
        n_refined = int(np.asarray(meta_r)[0])
        bits_r_np = np.asarray(bits_r)

        @functools.partial(jax.jit, static_argnames=("K",))
        def probe_arm(data, bounds, *, K):
            def body(acc, _):
                b2 = bounds.at[0, 0].add(acc & 1)
                total, _bits = _hits_jit(data, b2, words, cfg=cfg)
                return acc + total[0], None

            acc, _ = jax.lax.scan(
                body, jnp.zeros((), jnp.int32), None, length=K
            )
            return acc

        def host_side_once(bmp):
            t0 = time.perf_counter()
            rows, lanes = unpack_hit_rows(bmp, cfg.stride)
            arr = verifier.verify_batch_arrays(
                data_np, lanes, rows, halo, start_np, end_np
            )
            n_ev = len(arr[0]) if arr is not None else -1
            return time.perf_counter() - t0, n_ev

        best_dev = best_probe = best_ref = float("inf")
        best_rprobe = float("inf")
        best_host = best_rhost = float("inf")
        n_ev = 0
        for _ in range(args.rounds):  # interleave the arms
            best_dev = min(
                best_dev,
                timed(lambda K: int(device_arm(data, bounds, K=K))),
            )
            best_ref = min(
                best_ref,
                timed(lambda K: int(refined_arm(data, bounds, K=K))),
            )
            best_rprobe = min(
                best_rprobe,
                timed(lambda K: int(refined_probe_arm(data, bounds, K=K))),
            )
            best_probe = min(
                best_probe,
                timed(lambda K: int(probe_arm(data, bounds, K=K))),
            )
            h, n_ev = host_side_once(bits_np)
            best_host = min(best_host, h)
            rh, _ = host_side_once(bits_r_np)
            best_rhost = min(best_rhost, rh)

        print(json.dumps({
            "metric": "verify_ab",
            "config": tag,
            "cfg": f"q{cfg.q}s{cfg.stride}w{cfg.w}k{cfg.kbanks}v{cfg.v}"
                   + ("sampled" if cfg.sampled else ""),
            "density": density,
            "patterns": args.patterns,
            "bytes": size,
            "survivors": survivors,
            "events": n_ev,
            "k_cand": k_cand,
            "device_joint_s": best_dev,
            "device_joint_bytes_per_s": size / best_dev,
            "n_exact": n_exact,
            "k_walk": k_walk,
            "refined_joint_s": best_ref,
            "refined_joint_bytes_per_s": size / best_ref,
            "probe_only_s": best_probe,
            "device_verify_overhead_s": best_dev - best_probe,
            "host_side_s": best_host,
            "host_pipelined_bytes_per_s": size / max(best_probe, best_host),
            "bitmap_d2h_bytes": bits_np.nbytes,
            # refined host pipeline (probe+refine on device, host walks
            # the true-gram residue only)
            "n_refined": n_refined,
            "refined_probe_s": best_rprobe,
            "refine_overhead_s": best_rprobe - best_probe,
            "refine_ns_per_slot": (best_rprobe - best_probe) / k_cand * 1e9,
            "refined_host_s": best_rhost,
            "refined_pipelined_bytes_per_s":
                size / max(best_rprobe, best_rhost),
        }), flush=True)


if __name__ == "__main__":
    main()
