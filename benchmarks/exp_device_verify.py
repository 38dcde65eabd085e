"""Primitive-cost probes for the device-side verify stage design.

The device verify pipeline (ops/verify_device.py) needs, per batch:
  (a) nonzero-word extraction from the survivor bitmap  (~1-3e5 words)
  (b) candidate compaction                              (~1e3-1e4 cands)
  (c) a windowed DFA walk = 2 gathers per (cand, step)  (~1e5-1e6 gathers)
  (d) event compaction + per-group scatter-add          (~1e5 elements)

Where gather is serialized per element, whether scatter / top_k / sort
behave the same decides which compaction
strategy the verify kernel should use. Honest K-loop protocol (carry
threaded through an operand; fetch a scalar; difference t(K_hi)-t(K_lo)).
"""

from __future__ import annotations

import functools
import json
import sys
import os
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(make_fn, operands, K_LO=1, K_HI=9, n=4):
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("K",))
    def repeat(*ops, K):
        def body(acc, _):
            # perturb an operand with the carry so the loop body cannot be
            # hoisted; fold the result into the carry so it must execute
            out = make_fn(acc, *ops)
            return out, None

        acc, _ = jax.lax.scan(body, jnp.zeros((), jnp.int32), None, length=K)
        return acc

    def run(K):
        return int(repeat(*operands, K=K))

    run(K_LO)
    run(K_HI)

    def best(K):
        b = float("inf")
        for _ in range(n):
            t0 = time.perf_counter()
            run(K)
            b = min(b, time.perf_counter() - t0)
        return b

    return (best(K_HI) - best(K_LO)) / (K_HI - K_LO)


def main():
    import jax
    import jax.numpy as jnp


    rng = np.random.RandomState(0)
    results = {}

    # ---- scatter-set compaction: N elements -> K slots -------------------
    for N, K in ((262_144, 4096), (65_536, 4096), (163_840, 8192)):
        flags = jax.device_put(
            (rng.rand(N) < 0.01).astype(np.int32)
        )

        def compact(acc, flags):
            f = flags * 0 + flags + (acc & 0)  # depend on carry
            pos = jnp.cumsum(f) - f
            dst = jnp.where((f > 0) & (pos < K), pos, K)
            out = jnp.zeros((K,), jnp.int32).at[dst].set(
                jax.lax.broadcasted_iota(jnp.int32, (N, 1), 0).squeeze(-1),
                mode="drop",
            )
            return acc + out[0] + out[K - 1]

        results[f"scatter_compact_N{N}_K{K}_s"] = timeit(compact, (flags,))

    # ---- scatter-add: N indices into G bins -------------------------------
    for N, G in ((163_840, 8192), (8192, 8192)):
        idx = jax.device_put(rng.randint(0, G, size=N).astype(np.int32))

        def scatadd(acc, idx):
            i = idx + (acc & 0)
            out = jnp.zeros((G,), jnp.int32).at[i].add(1, mode="drop")
            return acc + out[0] + out[G - 1]

        results[f"scatter_add_N{N}_G{G}_s"] = timeit(scatadd, (idx,))

    # ---- top_k: first K set indices of N ----------------------------------
    for N, K in ((262_144, 2048), (65_536, 8192)):
        flags = jax.device_put((rng.rand(N) < 0.01).astype(np.int32))

        def topk(acc, flags):
            f = flags + (acc & 0)
            iota = jax.lax.broadcasted_iota(jnp.int32, (N, 1), 0).squeeze(-1)
            score = jnp.where(f > 0, -iota, jnp.iinfo(jnp.int32).min)
            vals, _ = jax.lax.top_k(score, K)
            return acc + vals[0] + vals[K - 1]

        results[f"topk_N{N}_K{K}_s"] = timeit(topk, (flags,))

    # ---- sort: N keys + 1 payload ------------------------------------------
    for N in (163_840, 262_144):
        keys = jax.device_put(rng.randint(0, 1 << 30, size=N).astype(np.int32))

        def dosort(acc, keys):
            k = keys + (acc & 0)
            sk, sv = jax.lax.sort((k, k), num_keys=1)
            return acc + sk[0] + sv[N - 1]

        results[f"sort_N{N}_s"] = timeit(dosort, (keys,))

    # ---- cumsum over the full expanded bitmap ------------------------------
    for N in (8_388_608,):
        flags = jax.device_put((rng.rand(N) < 0.001).astype(np.int32))

        def docs(acc, flags):
            f = flags + (acc & 0)
            c = jnp.cumsum(f)
            return acc + c[N - 1]

        results[f"cumsum_N{N}_s"] = timeit(docs, (flags,))

    # ---- the serialized-gather walk shape: WL steps x K lanes -------------
    table = jax.device_put(
        rng.randint(1, 1000, size=(1 << 20,)).astype(np.int32)
    )
    for K, WL in ((4096, 20), (8192, 20), (8192, 40)):
        syms = jax.device_put(
            rng.randint(0, 256, size=(WL, K)).astype(np.int32)
        )

        def walk(acc, syms, table=table, K=K, WL=WL):
            def body(state, blk):
                idx = (state * 7 + blk + (acc & 0)) & ((1 << 20) - 1)
                nxt = jnp.take(table, idx)
                return nxt, None

            st, _ = jax.lax.scan(
                body, jnp.zeros((K,), jnp.int32), syms
            )
            return acc + st[0] + st[K - 1]

        results[f"walk_K{K}_WL{WL}_s"] = timeit(walk, (syms,))

    # ---- data-window gather: K cands x WL bytes from [C*T] ---------------
    data = jax.device_put(
        rng.randint(0, 256, size=(4096 * 4352,)).astype(np.uint8)
    )
    for K, WL in ((8192, 20),):
        base = jax.device_put(
            rng.randint(0, 4096 * 4352 - 64, size=(K,)).astype(np.int32)
        )

        def wgather(acc, base, data=data, WL=WL):
            b = base + (acc & 0)
            idx = b[None, :] + jax.lax.broadcasted_iota(
                jnp.int32, (WL, 1), 0
            )
            out = jnp.take(data, idx.reshape(-1), mode="clip").astype(
                jnp.int32
            )
            return acc + out[0] + out[-1]

        results[f"window_gather_K{K}_WL{WL}_s"] = timeit(wgather, (base,))

    for k, v in results.items():
        print(json.dumps({k: v}))


def verify_stage_solo():
    """Time _verify_kernel alone (no probe) at official-like shapes, per
    stage-count bucket — where does the measured fused overhead live?"""
    import jax
    import jax.numpy as jnp

    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.ops.verify_device import _verify_kernel

    rng = np.random.RandomState(0)
    pats = [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(10_000)]
    table = compile_patterns(pats)
    C, T = 4096, 4352
    W = T // 32  # stride-1 (sampled) bitmap shape
    n_cand = 4600
    bits_np = np.zeros((W, C), np.uint32)
    wi = rng.randint(0, W, size=n_cand)
    ci = rng.randint(0, C, size=n_cand)
    bi = rng.randint(0, 32, size=n_cand)
    np.bitwise_or.at(bits_np, (wi, ci), np.uint32(1) << bi.astype(np.uint32))
    data = jax.device_put(
        rng.randint(0, 256, size=(C, T)).astype(np.uint8)
    )
    bounds = jax.device_put(
        np.stack([np.full(C, 16, np.int32), np.full(C, T, np.int32)])
    )
    bits = jax.device_put(bits_np.astype(np.int32))
    table_flat = jax.device_put(
        np.ascontiguousarray(table.goto_signed).reshape(-1)
    )
    state_gid = jax.device_put(table.state_gid.astype(np.int32))

    for k_cand in (4096, 8192):
        def vfn(acc, bits, k_cand=k_cand):
            b2 = bits | (acc & 0)
            m, _p, gc = _verify_kernel(
                table_flat, state_gid, data, bounds, b2,
                alphabet_size=256, stride=1, q=4, lmax=12, halo=16,
                k_cand=k_cand, k_ev=k_cand, num_groups=table.num_groups,
            )
            return acc + m[0] + gc[0]

        t = timeit(vfn, (bits,))
        print(json.dumps({f"verify_solo_k{k_cand}_s": t}))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "solo":
        verify_stage_solo()
    else:
        main()
