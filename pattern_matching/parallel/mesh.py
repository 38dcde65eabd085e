"""Device mesh construction and shardings.

The distributed layer the reference never had (SURVEY.md section 2.5): its
only "multi-device" story is N pthreads each owning a private OpenCL context
and a privately re-compiled DFA (ocl_aho_grep.c:494-502, ocl_worker.c:32-38).
Here the same data-parallel layout becomes a first-class mesh program:

- one ``Mesh`` over all devices, axis ``"data"`` (multi-host: hosts x
  devices flattened — XLA routes collectives over NVLink within a host and
  the network across hosts);
- the DFA table replicated: ``NamedSharding(mesh, P())`` — the analogue of
  each worker's ``d_trans`` copy, but expressed once as a sharding;
- batch lanes sharded on the ``data`` axis: ``P("data")`` on the lane dim;
- per-group match counts reduced with ``psum`` (BASELINE config 5).

Everything compiles under one ``jit``; XLA inserts the collectives.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pattern_matching.ops.match_xla import _scan_kernel
from pattern_matching.ops.table import DeviceTable


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
) -> None:
    """Multi-process bring-up (``jax.distributed.initialize`` wrapper).

    No-op for single-process runs and when a distributed client already
    exists (idempotent: library embedders may have initialized first).
    ``local_device_ids`` binds this process to those cards of its host:
    several processes on one host each pass their own card, or every
    process would open every card and reserve most of its memory. None
    (one process per host) keeps all of the host's cards.
    """
    if num_processes is not None and num_processes > 1:
        if jax.distributed.is_initialized():
            return
        jax.distributed.initialize(
            coordinator, num_processes, process_id,
            local_device_ids=local_device_ids,
        )


def make_mesh(devices=None, axis: str = "data") -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (axis,))


def as_mesh_context(spec) -> "MeshContext":
    """Coerce a user-facing mesh spec into a MeshContext.

    Accepts a MeshContext, a Mesh, an int (first-N devices), or the
    strings "all"/"auto" (every visible device) — the session/CLI entry
    point for the multi-chip path (the capability the reference only has
    as N worker threads each owning a device, ocl_aho_grep.c:494-502).
    """
    if isinstance(spec, MeshContext):
        return spec
    if isinstance(spec, Mesh):
        return MeshContext(spec)
    if spec in ("all", "auto", True):
        return MeshContext(make_mesh())
    if isinstance(spec, int):
        devs = jax.devices()
        if spec < 1 or spec > len(devs):
            raise ValueError(
                f"mesh size {spec} not available ({len(devs)} devices)"
            )
        return MeshContext(make_mesh(devs[:spec]))
    raise TypeError(f"cannot build a mesh from {spec!r}")


@dataclasses.dataclass
class MeshContext:
    """Sharding bundle for the data-parallel scan."""

    mesh: Mesh
    axis: str = "data"

    @property
    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())

    @property
    def lane_sharded(self) -> NamedSharding:
        # batches are lane-major [C, T]: shard lanes
        return NamedSharding(self.mesh, P(self.axis))

    @property
    def lane_sharded2d(self) -> NamedSharding:
        # [2, C] bounds arrays: shard the lane (second) dim
        return NamedSharding(self.mesh, P(None, self.axis))

    @property
    def num_devices(self) -> int:
        return self.mesh.size


def make_sharded_scan_step(
    ctx: MeshContext,
    table: DeviceTable,
    *,
    halo: int,
    max_results: int,
    num_groups: int,
):
    """Build the jitted multi-chip scan step.

    Input lanes sharded ``P("data")``, table replicated; returns per-lane
    results (lane-sharded) plus globally-reduced per-group counts — the
    ``psum`` count-reduction path of BASELINE config 5. Lanes must be a
    multiple of the mesh size.
    """
    lane = ctx.lane_sharded
    repl = ctx.replicated

    @functools.partial(
        jax.jit,
        in_shardings=(repl, repl, lane, lane, lane),
        out_shardings=(lane, lane, lane, repl),
        static_argnames=(),
    )
    def step(table_flat, state_gid, data, start_t, end_t):
        # gcounts accumulate INSIDE the scan from every report (exact even
        # when lanes overflow their R result slots — the slot-derived
        # reduction silently undercounted exactly on match-dense input),
        # then reduce across the mesh by XLA
        res = _scan_kernel(
            table_flat,
            jax.lax.optimization_barrier(data.T),
            start_t,
            end_t,
            alphabet_size=table.alphabet_size,
            halo=halo,
            max_results=max_results,
            state_gid=state_gid,
            num_groups=num_groups,
        )
        return res.counts, res.slot_state, res.slot_pos, res.gcounts

    return step


@dataclasses.dataclass
class MeshDenseMatches:
    """Dense-engine results of one meshed batch, lane-sharded.

    The transplanted reference design (ahomatch.cl's in-kernel tuple
    emission + the prefix-sum compaction) on a multi-process mesh: the
    single-array compaction referenced GLOBAL lanes no single host could
    decode, so the dense engine was single-process-only until round 5.
    Here each device compacts ITS OWN lanes and the packed blocks come
    back sharded ``P("data")`` — each host decodes exactly the lanes it
    fed, the same host-local layout as the bloom bitmap and the two
    device-verify event paths.

    ``metas[d] = [global_total, global_reported, local_total,
    local_reported]`` (global entries psum-replicated into every row);
    ``gcounts`` are the in-scan exact per-group counts, psum-reduced
    across the whole mesh (exact even past slot/capacity overflow)."""

    metas: jax.Array  # [D, 4] int32, lane-sharded rows
    packed: jax.Array  # [D, 5, cap] int32: lane, pos, state, gid, rep_pid
    gcounts: jax.Array  # [G] int32, replicated (global psum)


def make_sharded_dense_step(
    ctx: MeshContext,
    table: DeviceTable,
    *,
    halo: int,
    max_results: int,
    num_groups: int,
    capacity: int,
):
    """Scan + per-device compaction under shard_map (the dense engine's
    multi-process step). Unlike :func:`make_sharded_scan_step` (whose
    per-lane slot arrays this wraps), the compaction happens INSIDE the
    shard so result tuples never leave their owner device's lane shard.
    ``capacity`` bounds each DEVICE's packed block; totals stay exact
    past it (in-scan gcounts + psum'd totals)."""
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    from pattern_matching.ops.compact import _compact_jit

    axis = ctx.axis

    def local_step(table_flat, state_gid, group_rep, data, bounds):
        res = _scan_kernel(
            table_flat,
            jax.lax.optimization_barrier(data.T),
            bounds[0],
            bounds[1],
            alphabet_size=table.alphabet_size,
            halo=halo,
            max_results=max_results,
            state_gid=state_gid,
            num_groups=num_groups,
        )
        meta, packed = _compact_jit(
            res.counts,
            res.slot_state,
            res.slot_pos,
            state_gid,
            group_rep,
            capacity=capacity,
        )
        metas = jnp.concatenate(
            [jax.lax.psum(meta, axis), meta]
        )  # [g_total, g_reported, l_total, l_reported]
        return metas[None], packed[None], jax.lax.psum(res.gcounts, axis)

    step = jax.jit(
        shard_map(
            local_step,
            mesh=ctx.mesh,
            in_specs=(P(), P(), P(), P(axis), P(None, axis)),
            out_specs=(P(axis, None), P(axis, None, None), P()),
            check_vma=False,
        )
    )

    def run(data, bounds) -> MeshDenseMatches:
        metas, packed, gcounts = step(
            table.table_flat, table.state_gid, table.group_rep, data, bounds
        )
        return MeshDenseMatches(metas=metas, packed=packed, gcounts=gcounts)

    return run


def allreduce_host_counts(counts: np.ndarray) -> np.ndarray:
    """Sum per-host count vectors across processes.

    The host-side half of the bloom engine's psum count path (BASELINE
    config 5): each process counts the events it verified locally, then
    the vectors reduce over DCN. No-op single-process."""
    if jax.process_count() == 1:
        return np.asarray(counts)
    from jax.experimental import multihost_utils

    gathered = multihost_utils.process_allgather(np.asarray(counts))
    return np.asarray(gathered).reshape(jax.process_count(), -1).sum(axis=0)


def make_sharded_bloom_count_step(
    ctx: MeshContext,
    bloom,
    table,
    *,
    halo: int,
    k_cand: int = 4096,
    k_ev: int = 4096,
    gram_keys=None,
    k_walk: int | None = None,
):
    """The all-device psum count path for the flagship engine: bloom probe
    + device-side exact verify + per-group count psum in ONE jit under
    shard_map — zero host CPU in the verify loop (BASELINE config 5 with
    no host verify: multi-device group counts as a pure psum).

    Returns ``step(words, table_flat, state_gid, data, bounds) ->
    (gcounts [G] replicated, n_events [] replicated, flags [] replicated,
    needs [3] replicated)`` where ``flags != 0`` means SOME shard
    overflowed a fixed per-shard capacity (bit0 candidates, bit1 event
    slots, bit2 refined candidates) — gcounts are then incomplete and the
    caller must rescan with larger capacities (``needs`` = max per-shard
    [n_events, n_candidates, n_refined] are the EXACT sizes the rescan
    must cover; :class:`ShardedBloomCounter` does this automatically) or
    fall back to host verify; ``n_events`` stays exact either way.
    Per-shard capacities are static: unlike the single-chip decode path,
    a fused mesh step cannot bucket per batch.

    ``gram_keys`` (BloomFilterTable.gram_keys) enables the exact-gram
    refinement stage per shard: bloom fp candidates erase before the
    windowed walk (ops/exact_gram.py), so the per-shard walk capacity
    ``k_walk`` (default k_cand) covers true gram occurrences only. The
    exact table replicates to every device (closure-captured constants
    under shard_map).
    """
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    from pattern_matching.ops.bloom import _hits_jit
    from pattern_matching.ops.verify_device import _verify_kernel

    cfg = bloom.cfg
    axis = ctx.axis
    exact_lo = exact_hi = None
    exact_meta = None
    if gram_keys is not None and len(gram_keys):
        from pattern_matching.ops.exact_gram import table_from_keys

        rep = jax.sharding.NamedSharding(ctx.mesh, P())
        xt = table_from_keys(
            gram_keys, cfg.q, bits=(table.alphabet_size - 1).bit_length()
        )
        exact_lo = jax.device_put(xt.lo.view(np.int32), rep)
        exact_hi = (
            jax.device_put(xt.hi.view(np.int32), rep) if xt.use_hi else None
        )
        exact_meta = xt.device_meta(cfg.fold_case)
    kw = k_walk if k_walk is not None else k_cand

    def local_step(words, table_flat, state_gid, data, bounds):
        C_local = data.shape[0]
        if C_local % 128:
            raise ValueError(
                f"per-device lane count {C_local} must be a multiple of "
                f"128 (pad the batch to mesh_size*128 lanes)"
            )
        _total, bits = _hits_jit(
            data, bounds, words, cfg=cfg,
        )
        meta, _packed, gcounts = _verify_kernel(
            table_flat,
            state_gid,
            data,
            bounds,
            bits,
            exact_lo,
            exact_hi,
            alphabet_size=table.alphabet_size,
            stride=cfg.stride,
            q=cfg.q,
            lmax=table.max_pat_len,
            halo=halo,
            k_cand=k_cand,
            k_ev=k_ev,
            num_groups=table.num_groups,
            exact_meta=exact_meta,
            k_walk=kw,
        )
        # flags are a BITMASK: reduce with a bitwise OR across shards (a
        # psum would alias bits — two shards with bit0 sum to bit1).
        # pmax per extracted bit == OR for 0/1-valued bits.
        flags_or = (
            jax.lax.pmax(meta[3] & 1, axis)
            | jax.lax.pmax(meta[3] & 2, axis)
            | jax.lax.pmax(meta[3] & 4, axis)
        )
        needs = jnp.stack(
            [
                jax.lax.pmax(meta[0], axis),  # max per-shard events
                jax.lax.pmax(meta[2], axis),  # max per-shard candidates
                jax.lax.pmax(meta[4], axis),  # max per-shard refined
            ]
        )
        return (
            jax.lax.psum(gcounts, axis),
            jax.lax.psum(meta[0], axis),
            flags_or,
            needs,
        )

    return jax.jit(
        shard_map(
            local_step,
            mesh=ctx.mesh,
            in_specs=(P(), P(), P(), P(axis), P(None, axis)),
            out_specs=(P(), P(), P(), P()),
            check_vma=False,  # the verify walk's scan carries start
            # unvarying and pick up the lane axis (ops/verify_device.py)
        )
    )


class ShardedBloomCounter:
    """Product driver for the all-device psum count path with AUTOMATIC
    capacity retry: on any overflow flag the SAME
    batch rescans at capacities covering the exact reported needs —
    mirroring DeviceVerifier.verify's single-chip retry — so match-dense
    fleets never need manual capacity tuning. Recompiles are log-bounded
    by the next_cap ladder and capacities are sticky across batches (a
    persistently dense stream converges to one compiled step).
    """

    def __init__(self, ctx: MeshContext, bloom, table, *, halo: int,
                 k_cand: int = 4096, k_ev: int = 4096, gram_keys=None,
                 k_walk: int | None = None):
        self.ctx = ctx
        self.bloom = bloom
        self.table = table
        self.halo = halo
        self.gram_keys = gram_keys
        self.k_cand = k_cand
        self.k_ev = k_ev
        self.k_walk = k_walk if k_walk is not None else (
            k_cand if gram_keys is None else min(k_cand, 1024)
        )
        self._steps: dict[tuple[int, int, int], object] = {}
        rep = ctx.replicated
        self.table_flat = jax.device_put(
            np.ascontiguousarray(table.goto_signed).reshape(-1), rep
        )
        self.state_gid = jax.device_put(
            table.state_gid.astype(np.int32), rep
        )

    def _step(self, k_cand: int, k_ev: int, k_walk: int):
        key = (k_cand, k_ev, k_walk)
        if key not in self._steps:
            self._steps[key] = make_sharded_bloom_count_step(
                self.ctx, self.bloom, self.table, halo=self.halo,
                k_cand=k_cand, k_ev=k_ev, gram_keys=self.gram_keys,
                k_walk=k_walk,
            )
        return self._steps[key]

    def count(self, data, bounds) -> tuple[np.ndarray, int]:
        """(gcounts [G] int64, n_events) — exact, retrying capacities as
        needed. Raises RuntimeError past MAX_DEVICE_CAND per shard (host
        verify is the right tool for match-saturated batches)."""
        from pattern_matching.ops.verify_device import (
            MAX_DEVICE_CAND,
            next_cap,
        )

        for _ in range(8):  # log-bounded; 8 covers any ladder walk
            gcounts, n_ev, flags, needs_d = self._step(
                self.k_cand, self.k_ev, self.k_walk
            )(self.bloom.words, self.table_flat, self.state_gid,
              data, bounds)
            f = int(np.asarray(flags))
            if not f:
                return (
                    np.asarray(gcounts).astype(np.int64),
                    int(np.asarray(n_ev)),
                )
            needs = np.asarray(needs_d)
            if f & 1:  # candidate overflow: exact need is needs[1]
                if int(needs[1]) > MAX_DEVICE_CAND:
                    raise RuntimeError(
                        f"{int(needs[1])} candidates on one shard exceed "
                        f"the device cap {MAX_DEVICE_CAND}; use host "
                        f"verify for this stream"
                    )
                self.k_cand = next_cap(int(needs[1]))
            if f & 4:  # refined-candidate overflow
                self.k_walk = min(
                    next_cap(int(needs[2])), max(self.k_cand, 256)
                )
            if f & 2:  # event-slot overflow
                if int(needs[0]) > MAX_DEVICE_CAND:
                    raise RuntimeError(
                        f"{int(needs[0])} events on one shard exceed the "
                        f"device cap {MAX_DEVICE_CAND}; use host verify "
                        f"for this stream"
                    )
                self.k_ev = next_cap(int(needs[0]))
        raise RuntimeError("capacity retry did not converge (bug)")


def make_sharded_bloom_step(ctx: MeshContext, bloom):
    """Build the jitted multi-chip bloom-filter step (the flagship engine).

    The probe runs under ``shard_map`` so the bitmap's column->lane
    mapping stays per shard: every device scans its lane shard against the
    replicated bloom words (the reference's replicated-DFA-per-worker
    layout, as a sharding); the survivor total is ``psum``-reduced across
    the mesh while the bitmap stays lane-sharded for local host decode.

    Returns ``(meta [2], bits)`` where ``meta[0]`` is the global survivor
    total and ``meta[1]`` the MAX per-shard total — the capacity bound the
    meshed device-verify stage buckets with (:class:`MeshDeviceVerifier`).
    """
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    from pattern_matching.ops.bloom import _hits_jit

    cfg = bloom.cfg
    axis = ctx.axis

    def local_step(words, data, bounds):
        # each shard pads its local lane count to the 128-lane tile width
        # inside _hits_jit; an unaligned shard would shift the global
        # bitmap's column->lane mapping per shard (shard d's lane l lands
        # at d*Cpad+l, not d*C_local+l) and silently corrupt the decode
        C_local = data.shape[0]
        if C_local % 128:
            raise ValueError(
                f"per-device lane count {C_local} must be a multiple of "
                f"128 (pad the batch to mesh_size*128 lanes)"
            )
        total, bits = _hits_jit(
            data, bounds, words, cfg=cfg,
        )
        meta = jnp.concatenate(
            [jax.lax.psum(total, axis), jax.lax.pmax(total, axis)]
        )
        return meta, bits

    return jax.jit(
        shard_map(
            local_step,
            mesh=ctx.mesh,
            in_specs=(P(), P(axis), P(None, axis)),
            out_specs=(P(), P(None, axis)),
        )
    )


class MeshDeviceVerifier:
    """Lane-sharded device verify for EVENTS on a data-parallel mesh.

    The last capability the reference's kernel had over the meshed bloom
    engine: exact ``(pattern_set, offset)`` emission from the device in
    EVERY configuration (ahomatch.cl:63-74 — its kernel records pattern id
    + absolute end offset in-kernel, whether one GPU or N worker threads).
    Until round 4 a meshed session verified host-side per lane shard; this
    runs the full device verify pipeline (ops/verify_device._verify_kernel:
    candidate compaction, exact-gram refinement, windowed dense-table walk,
    attribution dedupe) PER SHARD under shard_map:

    - the dense table / exact-gram tables replicate as shard_map
      ARGUMENTS (a closed-over array would embed in the lowered module
      as an HLO constant — table-sized payload bloat at 300k+ pattern
      scales);
    - packed ``(lane, end, state)`` event tuples come back LANE-SHARDED
      (``P(None, "data")``) — events stay host-local to the process that
      owns the lanes, exactly like the bitmap decode path, so multi-host
      verbose grep needs zero host CPU in the verify loop and no cross-DCN
      event gather;
    - per-group counts psum to a replicated [G] (the config-5 workload);
    - ``needs`` (replicated [4]: global exact event total, max per-shard
      events, max per-shard refined candidates, OR of overflow flags)
      drives capacity retries identically on every process — the retry
      decision is SPMD-safe by construction.

    Capacities are static per compile and bucketed from the probe step's
    MAX per-shard survivor total (``make_sharded_bloom_step`` meta[1]), so
    candidate overflow cannot happen below MAX_DEVICE_CAND and compile
    count stays log-bounded; event/refine overflow retries with the exact
    reported need, mirroring the single-chip DeviceVerifier.
    """

    def __init__(self, ctx: MeshContext, table, cfg, halo: int,
                 gram_keys=None):
        self.ctx = ctx
        rep = ctx.replicated
        put = lambda x: jax.device_put(x, rep)  # noqa: E731
        self.table_flat = put(
            np.ascontiguousarray(table.goto_signed).reshape(-1)
        )
        self.state_gid = put(table.state_gid.astype(np.int32))
        self.alphabet_size = table.alphabet_size
        self.lmax = table.max_pat_len
        self.num_groups = table.num_groups
        self.stride = cfg.stride
        self.q = cfg.q
        self.halo = halo
        self.exact_lo = self.exact_hi = None
        self.exact_meta = None
        self._k_walk = 256  # sticky refined-capacity bucket (SPMD-safe:
        # updated from the replicated `needs`, so identical per process)
        self._steps: dict[tuple[int, int, int], object] = {}
        if gram_keys is not None and len(gram_keys):
            from pattern_matching.ops.exact_gram import table_from_keys

            xt = table_from_keys(
                gram_keys, cfg.q,
                bits=(table.alphabet_size - 1).bit_length(),
            )
            self.exact_lo = put(xt.lo.view(np.int32))
            self.exact_hi = (
                put(xt.hi.view(np.int32)) if xt.use_hi else None
            )
            self.exact_meta = xt.device_meta(cfg.fold_case)

    def _step(self, k_cand: int, k_ev: int, k_walk: int):
        key = (k_cand, k_ev, k_walk)
        if key in self._steps:
            return self._steps[key]
        try:
            from jax import shard_map
        except ImportError:  # older jax
            from jax.experimental.shard_map import shard_map

        from pattern_matching.ops.verify_device import _verify_kernel

        axis = self.ctx.axis

        # the dense/exact tables are shard_map ARGUMENTS, not closures: a
        # closed-over concrete array embeds in the lowered module as a
        # constant, which at large pattern scales bloats the HLO by the
        # table size
        def local_step(table_flat, state_gid, exact_lo, exact_hi,
                       data, bounds, bits):
            meta, packed, gcounts = _verify_kernel(
                table_flat,
                state_gid,
                data,
                bounds,
                bits,
                exact_lo,
                exact_hi,
                alphabet_size=self.alphabet_size,
                stride=self.stride,
                q=self.q,
                lmax=self.lmax,
                halo=self.halo,
                k_cand=k_cand,
                k_ev=k_ev,
                num_groups=self.num_groups,
                exact_meta=self.exact_meta,
                k_walk=k_walk,
            )
            # flags are a BITMASK: OR across shards via per-bit pmax
            flags_or = (
                jax.lax.pmax(meta[3] & 1, axis)
                | jax.lax.pmax(meta[3] & 2, axis)
                | jax.lax.pmax(meta[3] & 4, axis)
            )
            needs = jnp.stack(
                [
                    jax.lax.psum(meta[0], axis),  # exact global events
                    jax.lax.pmax(meta[0], axis),  # max per-shard events
                    jax.lax.pmax(meta[4], axis),  # max per-shard refined
                    flags_or,
                ]
            )
            return needs, meta[None], packed, jax.lax.psum(gcounts, axis)

        step = jax.jit(
            shard_map(
                local_step,
                mesh=self.ctx.mesh,
                in_specs=(P(), P(), P(), P(),
                          P(axis), P(None, axis), P(None, axis)),
                out_specs=(P(), P(axis, None), P(None, axis), P()),
                check_vma=False,
            )
        )
        self._steps[key] = step
        return step

    def _assemble(self, metas, packed, k_ev: int, C_local: int):
        """Host-local (lane, end, state) arrays from the lane-sharded
        packed tuples: each addressable shard's block rebases its local
        lane ids by the shard's global lane offset, then by this host's
        first lane — the same contiguous-per-process device-order
        assumption the bitmap decode makes (session._candidate_rows)."""
        per_meta: dict[int, np.ndarray] = {}
        for sh in metas.addressable_shards:
            d = sh.index[0].start or 0
            per_meta[d] = np.asarray(sh.data)[0]
        lanes, ends, states = [], [], []
        seen: set[int] = set()
        for sh in packed.addressable_shards:
            col0 = sh.index[1].start or 0
            d = col0 // k_ev
            if d in seen:
                continue
            seen.add(d)
            rep = int(per_meta[d][1])
            if not rep:
                continue
            blk = np.asarray(sh.data)[:, :rep]
            lanes.append(blk[0].astype(np.int64) + d * C_local)
            ends.append(blk[1].astype(np.int64))
            states.append(blk[2].astype(np.int64))
        lane0 = min(seen) * C_local if seen else 0
        if not lanes:
            z = np.zeros(0, np.int64)
            return z, z, z
        return (
            np.concatenate(lanes) - lane0,
            np.concatenate(ends),
            np.concatenate(states),
        )

    def verify(self, data, bounds, bits, total_max: int):
        """(n_events_global, lanes, ends, states, gcounts): exact device
        events for THIS HOST's lanes + globally-reduced per-group counts.
        Raises RuntimeError past MAX_DEVICE_CAND per shard (caller falls
        back to host verify of the lane-sharded bitmap — loud, lossless).
        Must be called in SPMD lockstep by every process."""
        from pattern_matching.ops.verify_device import (
            MAX_DEVICE_CAND,
            next_cap,
        )

        if total_max > MAX_DEVICE_CAND:
            raise RuntimeError(
                f"{total_max} candidates on one shard exceed the "
                f"device-verify cap {MAX_DEVICE_CAND}; host verify "
                f"handles this batch"
            )
        C_local = data.shape[0] // self.ctx.num_devices
        k_cand = next_cap(total_max)
        if self.exact_meta is None:
            k_walk = k_ev = k_cand
        else:
            k_walk = k_ev = min(k_cand, self._k_walk)
        needs_d, metas, packed, gc = self._step(k_cand, k_ev, k_walk)(
            self.table_flat, self.state_gid, self.exact_lo,
            self.exact_hi, data, bounds, bits
        )
        needs = np.asarray(needs_d)
        if needs[3] & 4:  # refine overflow: retry with the exact need
            k_walk = k_ev = min(k_cand, next_cap(int(needs[2])))
            needs_d, metas, packed, gc = self._step(k_cand, k_ev, k_walk)(
                self.table_flat, self.state_gid, self.exact_lo,
                self.exact_hi, data, bounds, bits
            )
            needs = np.asarray(needs_d)
        if needs[3] & 2:  # event overflow: retry with the exact need
            k_ev = next_cap(int(needs[1]))
            needs_d, metas, packed, gc = self._step(k_cand, k_ev, k_walk)(
                self.table_flat, self.state_gid, self.exact_lo,
                self.exact_hi, data, bounds, bits
            )
            needs = np.asarray(needs_d)
        if self.exact_meta is not None:
            self._k_walk = next_cap(int(needs[2]))
        if needs[3] & 1:
            raise RuntimeError(
                "mesh device verify candidate overflow with a bucketed "
                "capacity — probe max-total and bitmap disagree (bug)"
            )
        ln, e, st = self._assemble(metas, packed, k_ev, C_local)
        return int(needs[0]), ln, e, st, np.asarray(gc)
