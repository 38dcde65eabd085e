"""The DFA-walk scan engine (pure XLA).

Counterpart of the hot kernel ``ahomatch.cl``: the reference runs
one OpenCL work-item per chunk, walking the DFA byte-by-byte with two
dependent global loads per byte (ahomatch.cl:55-76). Here the walk is
vectorized across C independent chunk *lanes*: a ``lax.scan`` over time steps
where each step gathers C next-states from the flat table at once. Throughput
comes from scanning thousands of lanes in parallel per chip, not from
speeding one stream (SURVEY.md "hard parts").

Boundary semantics (replaces ahomatch.cl:96-158's lossy forward-continuation
heuristic — see SURVEY.md section 5 "long-context"): every lane carries a
*prefix halo* of up to ``max_pat_len - 1`` bytes of its stream's history.
The scan warms up through the halo from state 0 and only reports matches that
END inside the lane's own span. Since an Aho-Corasick match has length at
most ``max_pat_len``, a prefix halo of ``max_pat_len - 1`` bytes is exactly
sufficient: no straddling match is lost and none is double-reported. The halo
also subsumes the reference's cross-launch ``last_state`` carry
(ahomatch.cl:42-45, 90-93): batch N+1's halos are the tail bytes of batch N.

Layout: data is time-major ``[T, C]`` (T = halo + chunk bytes) so each scan
step reads one contiguous row across all lanes (coalesced loads), the
moral equivalent of the reference's coalesced column-major results layout
(old/ahomatch_with_scan.cl row-major -> ahomatch.cl column-major evolution).

Match capacity: fixed ``max_results`` slots per lane (static shapes for jit),
mirroring ``-R`` (databuf.h:9 MAX_RESULTS); the per-lane count is always
exact even when slots overflow, unlike the reference which silently drops
overflow (ahomatch.cl:66).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from pattern_matching.ops.table import DeviceTable


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ScanResult:
    """Per-lane match outputs (the ``results``/``results2`` analogue).

    ``counts[c]`` — exact number of match events in lane c's own span.
    ``slot_state[c, r]`` — DFA state of the r-th match (r < min(count, R));
    resolve to match groups / pattern ids via DeviceTable.state_gid.
    ``slot_pos[c, r]`` — 0-based offset of the match END within the lane's
    own span (halo excluded).
    ``gcounts[G]`` — exact per-match-group event counts, accumulated inside
    the scan from every report (NOT from the capped result slots), so they
    stay exact when lanes overflow their R slots. None unless the scan was
    asked for them (``state_gid`` passed).
    """

    counts: jax.Array  # [C] int32
    slot_state: jax.Array  # [C, R] int32
    slot_pos: jax.Array  # [C, R] int32
    gcounts: jax.Array | None = None  # [G] int32 when requested

    @property
    def total(self) -> jax.Array:
        return jnp.sum(self.counts)


def _scan_kernel(
    table_flat: jax.Array,
    data_tm: jax.Array,  # [T, C] uint8/uint16/int32 symbol columns
    start_t: jax.Array,  # [C] int32: first valid step (halo_start)
    end_t: jax.Array,  # [C] int32: one past last valid step
    *,
    alphabet_size: int,
    halo: int,
    max_results: int,
    state_gid: jax.Array | None = None,  # [S]: also emit exact gcounts
    num_groups: int = 0,
) -> ScanResult:
    T, C = data_tm.shape
    R = max_results
    want_gc = state_gid is not None
    G = num_groups
    # Block-unrolled scan: processing BLOCK symbols per loop iteration
    # amortizes the per-iteration loop bookkeeping (on a GPU, a launch per
    # iteration) over 8 symbols and lets XLA batch the gathers.
    block = next(b for b in (8, 4, 2, 1) if T % b == 0)
    r_iota = jax.lax.broadcasted_iota(jnp.int32, (R, C), 0)

    def walk_block(carry, blk, t0):
        """Signed-table walk of one block with full match bookkeeping."""
        state, count, sl_state, sl_pos, gc = carry
        nxts = []
        reports = []
        for k in range(block):
            t = t0 + k
            idx = state * alphabet_size + blk[k].astype(jnp.int32)
            raw = jnp.take(table_flat, idx).astype(jnp.int32)
            nxt = jnp.abs(raw)
            valid = (t >= start_t) & (t < end_t)
            state = jnp.where(valid, nxt, state)
            reports.append((raw < 0) & valid & (t >= halo))
            nxts.append(nxt)
        rep_blk = jnp.stack(reports)  # [block, C]
        nxt_blk = jnp.stack(nxts)  # [block, C]

        # Matches are rare: skip ALL slot bookkeeping (the [R, C] one-hot
        # updates) for blocks in which no lane matched — measured to close
        # most of the gap to a counts-only scan.
        def with_matches(args):
            count, sls, slp, gc = args
            for k in range(block):
                do = rep_blk[k] & (count < R)
                onehot = (r_iota == count[None, :]) & do[None, :]
                sls = jnp.where(onehot, nxt_blk[k][None, :], sls)
                slp = jnp.where(onehot, t0 + k - halo, slp)
                count = count + rep_blk[k].astype(jnp.int32)
                if want_gc:
                    # EVERY report feeds the group counts — unlike the
                    # capped slots, gcounts stay exact past R overflow
                    # (slot-derived counts would silently undercount
                    # exactly when input is match-dense)
                    gid = jnp.take(state_gid, nxt_blk[k], mode="clip")
                    idx = jnp.where(rep_blk[k], gid, G)
                    gc = gc.at[idx].add(
                        rep_blk[k].astype(jnp.int32), mode="drop"
                    )
            return count, sls, slp, gc

        def without_matches(args):
            count, sls, slp, gc = args
            return (
                count + jnp.sum(rep_blk.astype(jnp.int32), axis=0),
                sls,
                slp,
                gc,
            )

        count, sl_state, sl_pos, gc = jax.lax.cond(
            jnp.any(rep_blk),
            with_matches,
            without_matches,
            (count, sl_state, sl_pos, gc),
        )
        return (state, count, sl_state, sl_pos, gc)

    def body(carry, xs):
        blk, t0 = xs
        return walk_block(carry, blk, t0), None

    init = (
        jnp.zeros((C,), jnp.int32),
        jnp.zeros((C,), jnp.int32),
        jnp.zeros((R, C), jnp.int32),
        jnp.zeros((R, C), jnp.int32),
        jnp.zeros((G,), jnp.int32) if want_gc else jnp.zeros((), jnp.int32),
    )
    xs_blocks = data_tm.reshape(T // block, block, C)
    ts0 = (
        jax.lax.broadcasted_iota(jnp.int32, (T // block, 1), 0).squeeze(-1)
        * block
    )
    (state, count, sl_state, sl_pos, gc), _ = jax.lax.scan(
        body, init, (xs_blocks, ts0)
    )
    return ScanResult(
        counts=count,
        slot_state=sl_state.T,
        slot_pos=sl_pos.T,
        gcounts=gc if want_gc else None,
    )


@functools.partial(
    jax.jit, static_argnames=("alphabet_size", "halo", "max_results")
)
def _scan_batch_jit(
    table_flat,
    data,
    start_t,
    end_t,
    *,
    alphabet_size,
    halo,
    max_results,
):
    # lane-major [C, T] in; transpose once on device to time-major [T, C].
    # The barrier keeps XLA from fusing the transpose into the scan body
    # (fused, every step re-reads strided — measured 2x slower).
    data_tm = jax.lax.optimization_barrier(data.T)
    return _scan_kernel(
        table_flat,
        data_tm,
        start_t,
        end_t,
        alphabet_size=alphabet_size,
        halo=halo,
        max_results=max_results,
    )


def scan_batch(
    table: DeviceTable,
    data: jax.Array,  # [C, halo + B] lane-major symbols
    start_t: jax.Array,  # [C] int32
    end_t: jax.Array,  # [C] int32
    halo: int,
    max_results: int = 16,
) -> ScanResult:
    """Scan one batch of chunk lanes against the DFA.

    ``data[c]`` holds ``halo`` bytes of stream history (zero-filled and
    start-masked via ``start_t`` when less history exists) followed by the
    lane's own chunk bytes; ``end_t[c] = halo + size[c]``. Lanes with
    ``end_t == start_t == halo`` are empty padding lanes.
    """
    return _scan_batch_jit(
        table.table_flat,
        data,
        start_t,
        end_t,
        alphabet_size=table.alphabet_size,
        halo=halo,
        max_results=max_results,
    )
