"""A/B: meshed device-EVENT verify vs host verify, per batch, official point.

With MatchSession(mesh=..., verify="device"), what does the lane-sharded device event
path cost per batch next to the host native walker it replaces?

Arms (interleaved, honest K-loop where the work is device-side):

- ``mesh_verify``: the MeshDeviceVerifier step (candidate compaction +
  exact-gram refinement + windowed walk + event compaction + psum counts
  under shard_map on a 1-device mesh — the per-chip work of an N-chip
  mesh; collectives on 1 device are no-ops, so this isolates the compute)
  K-looped in one jit via the step's own jit, timed around repeated
  dispatch+sync (the step returns host-fetchable outputs; we difference
  K=1 vs K=5 sequential dispatches with a sync each to cancel nothing —
  dispatch+sync IS the per-batch product cost here).
- ``host_verify``: bitmap unpack + native window walk on the host CPU
  (the verify="host" default), wall time per batch.
- ``probe``: the probe alone (the stage both arms sit behind), for the
  pipelined-throughput arithmetic.

Usage: python benchmarks/exp_mesh_verify_ab.py [n_patterns] [density]
Prints one JSON line.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def main(n_patterns: int = 10_000, density: float = 1e-3) -> None:
    import jax

    sys.path.insert(0, ".")


    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.ops.bloom import (
        BloomFilterTable,
        unpack_hit_rows,
    )
    from pattern_matching.parallel.mesh import (
        MeshContext,
        MeshDeviceVerifier,
        make_mesh,
        make_sharded_bloom_step,
    )
    from pattern_matching.ops.verify_device import next_cap
    from pattern_matching.runtime.verify import Verifier
    from pattern_matching.utils.common import pad_halo

    rng = np.random.RandomState(42)
    pats = [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(n_patterns)]
    table = compile_patterns(pats)
    bft = BloomFilterTable.from_table(table)  # refined pick (the default)
    cfg = bft.cfg
    C, B0 = 4096, 4096
    halo = pad_halo(table.max_pat_len - 1, B0)
    B = B0 + (-(halo + B0)) % cfg.tile_rows
    size = C * B
    data_np = rng.randint(0, 256, size=(C, halo + B)).astype(np.uint8)
    if density > 0:
        n_seed = max(1, int(size * density) // 12)
        lanes_s = rng.randint(0, C, size=n_seed)
        pos_s = rng.randint(halo, halo + B - 12, size=n_seed)
        chosen = rng.randint(0, n_patterns, size=n_seed)
        for k in range(12):
            data_np[lanes_s, pos_s + k] = [pats[c][k] for c in chosen]
    start_np = np.full(C, halo, np.int32)
    end_np = np.full(C, halo + B, np.int32)

    ctx = MeshContext(make_mesh(jax.devices()[:1]))
    bloom = bft.put(ctx.replicated)
    probe_step = make_sharded_bloom_step(ctx, bloom)
    data = jax.device_put(data_np, ctx.lane_sharded)
    bounds = jax.device_put(np.stack([start_np, end_np]),
                            ctx.lane_sharded2d)
    meta, bits = probe_step(bloom.words, data, bounds)
    jax.block_until_ready(bits)
    total_max = int(np.asarray(meta)[1])

    mdv = MeshDeviceVerifier(ctx, table, cfg, halo,
                             gram_keys=bft.gram_keys)
    # warm + capacity-settle (the sticky k_walk adapts on the first call)
    n_ev, ln, e, st, gc = mdv.verify(data, bounds, bits, total_max)
    mdv.verify(data, bounds, bits, total_max)

    verifier = Verifier(
        [p.symbols for p in table.patterns],
        q=cfg.q, max_pat_len=table.max_pat_len, dense_table=table,
    )
    bits_np = np.asarray(bits)

    best_mesh = best_host = best_probe = float("inf")
    for _round in range(6):  # interleaved arms: contention hits all alike
        t0 = time.perf_counter()
        mdv.verify(data, bounds, bits, total_max)
        best_mesh = min(best_mesh, time.perf_counter() - t0)

        t0 = time.perf_counter()
        rows, lanes = unpack_hit_rows(bits_np, cfg.stride)
        verifier.verify_batch_arrays(
            data_np, lanes, rows, halo, start_np, end_np
        )
        best_host = min(best_host, time.perf_counter() - t0)

        t0 = time.perf_counter()
        m2, b2 = probe_step(bloom.words, data, bounds)
        jax.block_until_ready(b2)
        best_probe = min(best_probe, time.perf_counter() - t0)

    print(json.dumps({
        "metric": "mesh_verify_ab",
        "n_patterns": n_patterns,
        "density": density,
        "batch_bytes": size,
        "survivors": int(np.asarray(meta)[0]),
        "events": n_ev,
        "k_cand": next_cap(total_max),
        "mesh_device_verify_s_per_batch": best_mesh,
        "host_verify_s_per_batch": best_host,
        "probe_dispatch_s_per_batch": best_probe,
        # pipelined throughput if verify overlaps the next probe
        "pipelined_device_bytes_per_s": size / max(best_probe, best_mesh),
        "pipelined_host_bytes_per_s": size / max(best_probe, best_host),
    }))


if __name__ == "__main__":
    main(
        int(sys.argv[1]) if len(sys.argv) > 1 else 10_000,
        float(sys.argv[2]) if len(sys.argv) > 2 else 1e-3,
    )
