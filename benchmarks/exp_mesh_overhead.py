"""Mesh-step overhead on the real chip: plain probe vs shard_map probe.

The scaling table's 1-device anchor.
The data-parallel scan has no cross-device communication in its hot loop
(table replicated, lanes independent, one psum per batch), so the only
per-chip cost an N-chip mesh adds over the single-chip dispatch is the
shard_map/psum wrapper itself. Measuring that wrapper on a 1-DEVICE mesh
(collectives no-op) bounds the per-chip efficiency loss of the real mesh:

    efficiency >= t_plain / t_mesh   (per chip, compute side)

Protocol: honest K-loop (CLAUDE.md) — K probe iterations inside ONE jit
via lax.scan with the carry threaded through an operand, scalar fetch,
t(K_hi) - t(K_lo) differenced, arms interleaved, best-of-rounds.

Usage: python benchmarks/exp_mesh_overhead.py [n_patterns]
Prints one JSON line.
"""

from __future__ import annotations

import functools
import json
import sys
import time

import numpy as np


def main(n_patterns: int = 10_000) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    sys.path.insert(0, ".")


    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map

    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.ops.bloom import (
        BloomFilterTable,
        _hits_jit,
    )
    from pattern_matching.parallel.mesh import MeshContext, make_mesh
    from pattern_matching.utils.common import pad_halo

    rng = np.random.RandomState(42)
    pats = [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(n_patterns)]
    table = compile_patterns(pats)
    bft = BloomFilterTable.from_table(table, objective="probe")
    cfg = bft.cfg
    C, B0 = 4096, 4096
    halo = pad_halo(table.max_pat_len - 1, B0)
    B = B0 + (-(halo + B0)) % cfg.tile_rows
    size = C * B
    data_np = rng.randint(0, 256, size=(C, halo + B)).astype(np.uint8)
    bounds_np = np.stack([np.full(C, halo, np.int32),
                          np.full(C, halo + B, np.int32)])

    ctx = MeshContext(make_mesh(jax.devices()[:1]))
    words_r = jax.device_put(bft.words, ctx.replicated)
    data_sh = jax.device_put(data_np, ctx.lane_sharded)
    bounds_sh = jax.device_put(bounds_np, ctx.lane_sharded2d)
    words_p = jax.device_put(bft.words)
    data_p = jax.device_put(data_np)
    bounds_p = jax.device_put(bounds_np)

    def local_probe(words, data, bounds):
        total, _bits = _hits_jit(data, bounds, words, cfg=cfg)
        return jax.lax.psum(total, ctx.axis)

    mesh_probe = shard_map(
        local_probe, mesh=ctx.mesh,
        in_specs=(P(), P(ctx.axis), P(None, ctx.axis)),
        out_specs=P(), check_vma=False,
    )

    @functools.partial(jax.jit, static_argnames=("K",))
    def plain(data, bounds, *, K):
        def body(acc, _):
            b2 = bounds.at[0, 0].add(acc & 1)
            total, _bits = _hits_jit(data, b2, words_p, cfg=cfg)
            return acc + total[0], None

        acc, _ = jax.lax.scan(body, jnp.zeros((), jnp.int32), None,
                              length=K)
        return acc

    @functools.partial(jax.jit, static_argnames=("K",))
    def meshed(data, bounds, *, K):
        def body(acc, _):
            b2 = bounds.at[0, 0].add(acc & 1)
            total = mesh_probe(words_r, data, b2)
            return acc + total[0], None

        acc, _ = jax.lax.scan(body, jnp.zeros((), jnp.int32), None,
                              length=K)
        return acc

    arms = {
        "plain": lambda K: int(plain(data_p, bounds_p, K=K)),
        "mesh": lambda K: int(meshed(data_sh, bounds_sh, K=K)),
    }
    K_LO, K_HI = 1, 5
    for run in arms.values():
        run(K_LO)
        run(K_HI)  # compile
    best = {name: {K_LO: float("inf"), K_HI: float("inf")}
            for name in arms}
    for _round in range(6):
        for name, run in arms.items():
            for K in (K_LO, K_HI):
                t0 = time.perf_counter()
                run(K)
                best[name][K] = min(best[name][K],
                                    time.perf_counter() - t0)
    per = {
        name: (best[name][K_HI] - best[name][K_LO]) / (K_HI - K_LO)
        for name in arms
    }
    print(json.dumps({
        "metric": "mesh_step_overhead",
        "n_patterns": n_patterns,
        "batch_bytes": size,
        "plain_s_per_batch": per["plain"],
        "mesh_s_per_batch": per["mesh"],
        "plain_bytes_per_s": size / per["plain"],
        "mesh_bytes_per_s": size / per["mesh"],
        "per_chip_efficiency": per["plain"] / per["mesh"],
    }))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 10_000)
