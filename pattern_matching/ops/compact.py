"""Match compaction and sorting.

Replacement for the reference's three-kernel pipeline:

- prefix sum over per-chunk counts: the Apple-style recursive Blelloch scan
  (ocl_prefix_sum.c:389-498 + prefixsum.cl) becomes a single ``jnp.cumsum`` —
  XLA lowers this natively; the reference's canonical tree ships this
  path latently broken (it loads an empty ``scan_kernel.cl``,
  ocl_prefix_sum.c:71-77).
- stream compaction: the scatter of column-major match slots to
  prefix-sum offsets (compactarray.cl:40-68) becomes one vectorized
  ``.at[idx].set(..., mode="drop")`` scatter into a fixed-capacity array.
- sorting: the NVIDIA-sample bitonic sorter the reference never wired in
  (ocl_bitonic_sort.c references clconf fields that don't exist — SURVEY.md
  section 2.1) becomes ``jax.lax.sort`` over (offset, value) operands.

All shapes are static (``capacity`` slots), keeping the whole pipeline
jit-compatible; ``reported`` says how many leading slots are live.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from pattern_matching.ops.match_xla import ScanResult
from pattern_matching.ops.table import DeviceTable


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CompactMatches:
    """Dense (lane, pos, state, gid, rep_pid) tuples for one batch.

    ``meta = [total, reported]``: total is the exact event count (including
    per-lane slot overflow); reported is the number of live entries
    (<= capacity). ``packed`` stacks the five tuple arrays as [5, K] so the
    host fetches results in ONE device-to-host transfer (per-field pulls are
    latency-bound). ``pos`` is the match END offset within the lane's own
    span; absolute stream/file offsets are ``base_off[lane] + pos`` computed
    host-side in 64-bit (device arrays stay int32 — JAX default).
    ``gcounts`` are the in-scan exact per-group counts (see
    ScanResult.gcounts) — exact even when result slots overflow.
    """

    meta: jax.Array  # [2] int32: total, reported
    packed: jax.Array  # [5, K] int32: lane, pos, state, gid, rep_pid
    gcounts: jax.Array | None = None  # [G] int32

    @property
    def total(self) -> jax.Array:
        return self.meta[0]

    @property
    def reported(self) -> jax.Array:
        return self.meta[1]

    @property
    def lane(self) -> jax.Array:
        return self.packed[0]

    @property
    def pos(self) -> jax.Array:
        return self.packed[1]

    @property
    def state(self) -> jax.Array:
        return self.packed[2]

    @property
    def gid(self) -> jax.Array:
        return self.packed[3]

    @property
    def rep_pid(self) -> jax.Array:
        return self.packed[4]


@functools.partial(jax.jit, static_argnames=("capacity",))
def _compact_jit(counts, slot_state, slot_pos, state_gid, group_rep, *, capacity):
    C, R = slot_state.shape
    rep = jnp.minimum(counts, R)
    # exclusive prefix sum over reported per-lane counts (the
    # ocl_prefix_sum role)
    starts = jnp.cumsum(rep) - rep
    r_iota = jax.lax.broadcasted_iota(jnp.int32, (C, R), 1)
    dst = starts[:, None] + r_iota
    live = r_iota < rep[:, None]
    dst = jnp.where(live & (dst < capacity), dst, capacity)  # drop overflow
    lane_ids = jax.lax.broadcasted_iota(jnp.int32, (C, R), 0)

    out_lane = jnp.zeros((capacity,), jnp.int32).at[dst.ravel()].set(
        lane_ids.ravel(), mode="drop"
    )
    out_pos = jnp.zeros((capacity,), jnp.int32).at[dst.ravel()].set(
        slot_pos.ravel(), mode="drop"
    )
    out_state = jnp.zeros((capacity,), jnp.int32).at[dst.ravel()].set(
        slot_state.ravel(), mode="drop"
    )
    reported = jnp.minimum(jnp.sum(rep), capacity)
    total = jnp.sum(counts)
    gid = jnp.where(out_state > 0, jnp.take(state_gid, out_state, mode="clip"), -1)
    rep_pid = jnp.where(gid >= 0, jnp.take(group_rep, gid, mode="clip"), -1)
    meta = jnp.stack([total, reported])
    packed = jnp.stack([out_lane, out_pos, out_state, gid, rep_pid])
    return meta, packed


def compact_matches(
    table: DeviceTable,
    result: ScanResult,
    capacity: int | None = None,
) -> CompactMatches:
    """Compact per-lane slots into dense match tuples (device-side).

    ``capacity`` bounds the dense result (and therefore the single
    device-to-host transfer that fetches it); totals stay exact past it.
    """
    C, R = result.slot_state.shape
    if capacity is None:
        capacity = min(C * R, 8192)
    meta, packed = _compact_jit(
        result.counts,
        result.slot_state,
        result.slot_pos,
        table.state_gid,
        table.group_rep,
        capacity=capacity,
    )
    return CompactMatches(meta=meta, packed=packed)


@functools.partial(jax.jit, static_argnames=("chunk_len",))
def _sort_jit(meta, packed, *, chunk_len):
    lane, pos, state, gid, rep_pid = packed
    K = lane.shape[0]
    # key = within-batch absolute position; dead slots pushed to the end
    key = lane * chunk_len + pos
    slot_iota = jax.lax.broadcasted_iota(jnp.int32, (K, 1), 0).squeeze(-1)
    key = jnp.where(slot_iota < meta[1], key, jnp.iinfo(jnp.int32).max)
    key, lane, pos, state, gid, rep_pid = jax.lax.sort(
        (key, lane, pos, state, gid, rep_pid), num_keys=1
    )
    return jnp.stack([lane, pos, state, gid, rep_pid])


def sort_matches(m: CompactMatches, chunk_len: int) -> CompactMatches:
    """Order compacted matches by within-batch position (BitonicSort role)."""
    packed = _sort_jit(m.meta, m.packed, chunk_len=chunk_len)
    return CompactMatches(meta=m.meta, packed=packed)


@functools.partial(
    jax.jit,
    static_argnames=("alphabet_size", "halo", "max_results", "capacity",
                     "sort", "chunk_len", "num_groups"),
)
def _scan_compact_jit(
    table_flat,
    state_gid,
    group_rep,
    data,
    bounds,  # [2, C] int32: start_t, end_t (packed: one H2D transfer)
    *,
    alphabet_size,
    halo,
    max_results,
    capacity,
    sort,
    chunk_len,
    num_groups,
):
    from pattern_matching.ops.match_xla import _scan_kernel

    data_tm = jax.lax.optimization_barrier(data.T)
    res = _scan_kernel(
        table_flat,
        data_tm,
        bounds[0],
        bounds[1],
        alphabet_size=alphabet_size,
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
    if sort:
        packed = _sort_jit(meta, packed, chunk_len=chunk_len)
    return meta, packed, res.gcounts


def scan_and_compact(
    table: DeviceTable,
    data,
    bounds,
    *,
    halo: int,
    max_results: int = 16,
    capacity: int | None = None,
    sort: bool = False,
    chunk_len: int = 0,
) -> CompactMatches:
    """Scan + compact (+ optional sort) in ONE device dispatch.

    The multi-call pipeline (scan, compact, sort as separate jits) costs a
    host-device roundtrip per stage — significant on remote-attached
    devices; the reference pays the same structure as three kernel launches
    per round (SURVEY 3.2/3.3).
    """
    C = data.shape[0]
    if capacity is None:
        capacity = min(C * max_results, 8192)
    meta, packed, gcounts = _scan_compact_jit(
        table.table_flat,
        table.state_gid,
        table.group_rep,
        data,
        bounds,
        alphabet_size=table.alphabet_size,
        halo=halo,
        max_results=max_results,
        capacity=capacity,
        sort=sort,
        chunk_len=chunk_len,
        num_groups=table.num_groups,
    )
    return CompactMatches(meta=meta, packed=packed, gcounts=gcounts)


def per_group_counts(table: DeviceTable, m: CompactMatches) -> jax.Array:
    """Per-match-group event counts [G] (device-side, psum-able).

    Prefers the in-scan ``m.gcounts`` (exact regardless of slot overflow);
    the slot-derived reduction below is the fallback for CompactMatches
    built without them and is exact only when no lane overflowed its R
    result slots. The sentiment/count workload (BASELINE config 5) reduces
    this across the mesh with psum and expands groups to per-pattern
    scores host-side.
    """
    if m.gcounts is not None:
        return m.gcounts

    @jax.jit
    def _f(gid, reported):
        K = gid.shape[0]
        slot_iota = jax.lax.broadcasted_iota(jnp.int32, (K, 1), 0).squeeze(-1)
        live = (slot_iota < reported) & (gid >= 0)
        return (
            jnp.zeros((table.num_groups,), jnp.int32)
            .at[jnp.where(live, gid, table.num_groups)]
            .add(live.astype(jnp.int32), mode="drop")
        )

    return _f(m.gid, m.reported)
