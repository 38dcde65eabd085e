"""Device-side exact verify for the bloom engine.

The bloom engine's flagship probe (ops/bloom.py) emits candidate grams; the
exactness stage traditionally ran on the host CPU (runtime/verify.py + the
native walker). That works on one chip with spare cores, but at the measured
~1e-3 candidates/byte and ~8 GB/s/chip the host needs ~2 cores per chip and
becomes THE scaling wall on a mesh — and per-group counts (the psum workload,
BASELINE config 5) had to round-trip through host Python.

This module verifies ON DEVICE, giving the bloom engine the one capability
the reference's hot kernel had over it: exact ``(pattern_set, offset)``
emission from the device (ahomatch.cl:63-74 records pattern id + absolute
end offset in the scan kernel itself). Pipeline (one jit):

1. **Candidate compaction** — two-stage cumsum+scatter over the survivor
   bitmap: nonzero WORDS compact first (a word has >= 1 candidate, so the
   candidate capacity bounds the word capacity too), then their bits expand
   and compact to ``(lane, row)`` pairs sorted by (lane, row).
2. **Windowed DFA walk** — each candidate's window
   ``[row - (lmax-q), row + lmax)`` is walked from the root state with the
   dense signed table (the ops/match_xla encoding): a lax.scan over window
   steps, each step one vectorized gather across all candidate windows.
   The walk is a chain of dependent gathers, but only over candidate
   windows — at rate r candidates per byte it touches ~r * (2*lmax - q)
   of the input.
3. **Exact dedupe by attribution** — match end ``e`` is reported by
   candidate ``i`` iff ``r_i <= e - q + 1 < r_next`` (the next candidate in
   the same lane). Every true match contains >= 1 candidate gram inside its
   span (the coverage guarantee, MATCHING.md), so exactly one candidate owns
   each match end; and since ``e >= r_i + q - 1`` implies every pattern
   ending at e starts inside candidate i's window, the walked state's match
   group at e is complete. No cross-window merging, no duplicates — the
   device analogue of the host verifier's window merge (verify.py).
4. **Outputs** — compacted (lane, end_row, state) event tuples (fixed
   capacity + exact totals) and per-group counts [G] for the psum workload,
   all device-resident.

Capacities are BUCKETED: the caller fetches the probe's exact survivor
total first (one 4-byte transfer, already part of the decode protocol) and
dispatches with the next bucketed capacity, so candidate overflow
cannot happen below the cap and compile count stays log2-bounded. Event
overflow is detected exactly (meta) and retried with the exact needed
capacity.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

INT32_MAX = np.iinfo(np.int32).max


def next_cap(n: int, lo: int = 256) -> int:
    """Smallest capacity >= n on the {1, 1.5} x 2^k ladder.

    The walk's marginal cost is linear in the capacity bucket, so the
    power-of-two ladder's ~33% average waste was real milliseconds; the
    denser ladder halves the waste for at most 2x the compile count
    (still log-bounded)."""
    k = lo
    while k < n:
        k15 = k + (k >> 1)
        if k15 >= n:
            return k15
        k *= 2
    return k


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DeviceVerifyResult:
    """Device-resident exact events of one batch.

    ``meta = [n_events, reported, n_cand, flags, n_exact]``; flags bit0 =
    candidate capacity overflow (results incomplete — impossible when the
    capacity bucket was chosen from the probe total), bit1 = event capacity
    overflow (``packed`` truncated and ``gcounts`` incomplete; ``n_events``
    stays exact, so the caller retries with that capacity — the session
    path does automatically), bit2 = refined-candidate (k_walk) overflow
    (walk ran on a truncated candidate set; ``n_exact`` is the exact
    post-refinement survivor count, so the caller retries with it).
    ``packed[3, K]`` = (lane, end_row, state) sorted by (lane, end_row).
    """

    meta: jax.Array  # [5] int32
    packed: jax.Array  # [3, K] int32
    gcounts: jax.Array  # [G] int32


def _compact_flags(flags_flat, values, capacity):
    """top_k stream compaction: the positions of set ``flags_flat`` keep
    their relative order; each ``values`` array is gathered at the
    compacted positions. Returns (n_set, [compacted arrays], overflowed).

    Formulation: ``lax.top_k`` over the flags instead of the natural
    cumsum+scatter, so the per-value cost is a capacity-sized gather
    rather than a scatter over every SOURCE element (which of the two
    wins on the GPU is not measured yet; benchmarks/exp_compact_ab.py is
    the A/B). Selection key: set position
    i bids N - i, so descending top_k yields set positions in ASCENDING
    index order (the order contract callers rely on); unset slots bid -1
    and sort after every valid key. Overflow keeps the FIRST ``capacity``
    set positions, matching the scatter formulation's ``pos < capacity``
    rule."""
    N = flags_flat.shape[0]
    n = jnp.sum(flags_flat.astype(jnp.int32))
    iota = jax.lax.broadcasted_iota(jnp.int32, (N, 1), 0).squeeze(-1)
    key = jnp.where(flags_flat, jnp.int32(N) - iota, jnp.int32(-1))
    k = min(capacity, N)
    top, _ = jax.lax.top_k(key, k)
    if k < capacity:
        top = jnp.pad(top, (0, capacity - k), constant_values=-1)
    valid = top >= 0
    src = jnp.clip(jnp.int32(N) - top, 0, N - 1)
    outs = [
        jnp.where(valid, jnp.take(v, src, mode="clip"), fill).astype(v.dtype)
        for v, fill in values
    ]
    return n, outs, n > capacity


def bitmap_to_candidates(bits, stride: int, k_cand: int):
    """Survivor bitmap [W, Cb] -> compacted (lane, row)-sorted candidates.

    Two-stage cumsum+scatter: nonzero WORDS compact first (a nonzero word
    holds >= 1 candidate, so k_cand bounds the word count too), then their
    bits expand and compact. Returns (n_cand, lane[k_cand], row[k_cand],
    overflowed); sentinel slots hold (lane=Cb, row=INT32_MAX). Shared by
    the verify kernel's stages 1-2 and the refined-probe path
    (ops/bloom._hits_refined_jit)."""
    W, Cb = bits.shape
    wordsT = bits.T  # [Cb, W] (lane-major so candidates sort by lane)
    n_words, (widx, wval), _w_over = _compact_flags(
        (wordsT != 0).reshape(-1),
        [
            (
                jax.lax.broadcasted_iota(
                    jnp.int32, (Cb * W, 1), 0
                ).squeeze(-1),
                jnp.int32(Cb * W),
            ),
            (wordsT.reshape(-1), jnp.int32(0)),
        ],
        k_cand,
    )
    bit_iota = jax.lax.broadcasted_iota(jnp.int32, (k_cand, 32), 1)
    has_bit = (
        jax.lax.shift_right_logical(wval[:, None], bit_iota) & 1
    ) > 0  # padded slots have wval == 0 -> no bits
    lane_w = widx // W  # sentinel slots -> lane Cb: inert
    row_w = (widx % W) * 32
    rows32 = (row_w[:, None] + bit_iota) * stride
    lanes32 = jnp.broadcast_to(lane_w[:, None], (k_cand, 32))
    n_cand, (lane, row), cand_over = _compact_flags(
        has_bit.reshape(-1),
        [
            (lanes32.reshape(-1), jnp.int32(Cb)),
            (rows32.reshape(-1), jnp.int32(INT32_MAX)),
        ],
        k_cand,
    )
    return n_cand, lane, row, cand_over


def _verify_kernel(
    table_flat,
    state_gid,
    data,  # [C, T] symbols (the SAME device array the probe scanned)
    bounds,  # [2, C] start_t / end_t
    bits,  # [W, C] survivor bitmap from the probe
    exact_lo=None,  # [M + dmax] int32 exact-gram table plane (or None)
    exact_hi=None,  # second plane, only consumed when q > 4
    *,
    alphabet_size: int,
    stride: int,
    q: int,
    lmax: int,
    halo: int,
    k_cand: int,
    k_ev: int,
    num_groups: int,
    exact_meta: tuple | None = None,  # ExactGramTable.device_meta tuple:
    # static lookup parameters for the exact-gram refinement stage
    # (ops/exact_gram.py); None disables refinement
    k_walk: int | None = None,  # candidate capacity AFTER refinement
    # (the walk/event stages run at this width); defaults to k_cand
    prefetch_windows="auto",  # "bitcast" | "rowgather" | False | "auto"
    stages: int = 5,  # bench hook (exp_verify_stages.py): truncate the
    # pipeline after stage N (2=candidates, 3=walk, 4=events, 5=full);
    # truncated outputs are zero-filled except the live diagnostics in
    # ``meta`` — product callers never pass this
):
    C, T = data.shape
    W, Cb = bits.shape  # Cb >= C: the probe pads lanes to a 128 multiple
    G = num_groups      # (padded lanes have start==end: no candidates)

    # ---- stages 1+2: bitmap -> compacted (lane, row) candidates -----------
    n_cand, lane, row, cand_over = bitmap_to_candidates(bits, stride, k_cand)
    slot = jax.lax.broadcasted_iota(jnp.int32, (k_cand, 1), 0).squeeze(-1)
    cand_valid = slot < n_cand
    data_flat = data.reshape(-1)

    if stages <= 2:  # bench hook: candidates only
        z = jnp.zeros((), jnp.int32)
        meta = jnp.stack([z, z, jnp.minimum(n_cand, INT32_MAX),
                          cand_over.astype(jnp.int32), z])
        return (
            meta,
            jnp.zeros((3, k_ev), jnp.int32),
            jnp.zeros((num_groups,), jnp.int32),
        )

    # ---- stage 2.5: exact-gram refinement ---------------------------------
    # Erase candidates whose gram is not LITERALLY in the inserted set
    # (the bloom fp component) before the expensive windowed walk:
    # ~dmax+q gathers per candidate vs ~WL table gathers for the walk.
    # Exactness: any candidate subset containing every true-gram position
    # preserves the ownership argument below (same reasoning as the bloom
    # erasing positions in the first place — see module docstring and
    # ops/exact_gram.py).
    if exact_meta is not None:
        from .exact_gram import DeviceExact, exact_member

        dx = DeviceExact.from_meta(exact_lo, exact_hi, q, True, exact_meta)
        base_g = jnp.minimum(lane, C - 1) * T + jnp.minimum(row, T - 1)
        keep = exact_member(dx, data_flat, base_g, cand_valid)
        kw = k_walk if k_walk is not None else k_cand
        n_exact, (lane, row), refine_over = _compact_flags(
            keep,
            [(lane, jnp.int32(Cb)), (row, jnp.int32(INT32_MAX))],
            kw,
        )
        slot = jax.lax.broadcasted_iota(jnp.int32, (kw, 1), 0).squeeze(-1)
        cand_valid = slot < n_exact
    else:
        kw = k_cand
        n_exact = n_cand
        refine_over = jnp.zeros((), jnp.bool_)
    base_flags = cand_over.astype(jnp.int32) | (
        refine_over.astype(jnp.int32) << 2
    )

    # next candidate row in the same lane closes each keep interval
    # (candidates are (lane, row)-sorted: stage-1 order is lane-major,
    # bits within a word ascend, and the refinement compaction is
    # order-preserving)
    rnext = jnp.where(
        (lane[1:] == lane[:-1]),
        row[1:],
        jnp.int32(INT32_MAX),
    )
    rnext = jnp.concatenate([rnext, jnp.full((1,), INT32_MAX, jnp.int32)])

    # ---- stage 3: windowed walk -------------------------------------------
    pad_l = lmax - q
    WL = 2 * lmax - q
    WLp = -(-WL // 4) * 4  # unroll blocks of 4 (amortized scan bookkeeping)
    lane_c = jnp.minimum(lane, C - 1)
    st_c = jnp.where(cand_valid, bounds[0][lane_c], 0)
    en_c = jnp.where(cand_valid, bounds[1][lane_c], 0)
    w0 = row - pad_l
    base = lane_c * T + w0
    keep_lo = jnp.maximum(row + q - 1, halo)
    # Window prefetch: where gather cost is per gathered ELEMENT, ONE
    # uint32 gather of WLp/per+1 packed words per candidate replaces WLp
    # per-symbol gathers of the data side of the walk (the table gather
    # chain is data-dependent and stays).  `per` symbols
    # pack into each word (4 x uint8 or 2 x uint16; probe batches are
    # tile-rows aligned so the bitcast needs no padding).  Little-endian
    # element order (bitcast element 0 = low byte) is asserted by
    # tests/test_verify_device.py and on the card by
    # tests/test_gpu_hardware.py.
    itemsize = data.dtype.itemsize
    per = 4 // itemsize
    if prefetch_windows == "auto":
        # the batch-wide bitcast relayout is a fixed cost per batch and
        # the word prefetch saves per candidate slot, so it pays past a
        # slot count; 8k is the crossover exp_walk_ab.py found on the
        # earlier accelerator and is not yet measured on the GPU
        prefetch_windows = "bitcast" if kw >= 8192 else False
    if prefetch_windows and per > 1 and (C * T) % per == 0:
        bitsz = 8 * itemsize
        n_w = WLp // per + 1
        # signed align-down: valid positions always resolve to in-range
        # words; out-of-window slots are masked by `valid` downstream
        offp = base & (per - 1)
        log2_per = per.bit_length() - 1
        widx = (base >> log2_per)[:, None] + jax.lax.broadcasted_iota(
            jnp.int32, (1, n_w), 1
        )
        widx_cl = jnp.clip(widx, 0, (C * T) // per - 1)
        if prefetch_windows == "rowgather":
            # gather per-a-row slices of the reshaped uint8 view — no
            # bitcast relayout; pays off iff the gather is charged per
            # OFFSET rather than per element (A/B: exp_walk_ab.py)
            win = jnp.take(
                data.reshape((C * T) // per, per), widx_cl, axis=0
            )  # [kw, n_w, per]
            wsyms = win.astype(jnp.int32).reshape(kw, per * n_w)
        else:
            data_words = jax.lax.bitcast_convert_type(
                data.reshape((C * T) // per, per), jnp.uint32
            )
            win_words = jnp.take(data_words, widx_cl, mode="clip")
            wsyms = jnp.stack(
                [
                    (
                        jax.lax.shift_right_logical(
                            win_words, jnp.uint32(bitsz * j)
                        ).astype(jnp.int32)
                        & ((1 << bitsz) - 1)
                    )
                    for j in range(per)
                ],
                axis=-1,
            ).reshape(kw, per * n_w)
        wsymsT = wsyms.T  # [per*n_w, kw]: steps slice the major axis
    else:  # 4-byte symbols: nothing to pack
        wsymsT = offp = None
    # e - q + 1 < rnext  <=>  e < rnext + q - 1 (rnext may be INT32_MAX:
    # clamp the sum in int64-free fashion by bounding with window end)
    keep_hi = jnp.minimum(
        jnp.where(
            rnext >= INT32_MAX - q, jnp.int32(INT32_MAX), rnext + q - 1
        ),
        en_c,
    )

    def step(state, t, sym):
        pos = w0 + t
        raw = jnp.take(
            table_flat, state * alphabet_size + sym, mode="clip"
        ).astype(jnp.int32)
        valid = (pos >= st_c) & (pos < en_c)
        nxt = jnp.where(valid, jnp.abs(raw), state)
        rep = (raw < 0) & valid & (pos >= keep_lo) & (pos < keep_hi)
        return nxt, rep

    def body(state, t0):
        if wsymsT is None:
            syms = [
                jnp.take(
                    data_flat,
                    jnp.clip(base + (t0 + k), 0, C * T - 1),
                    mode="clip",
                ).astype(jnp.int32)
                for k in range(4)
            ]
        else:
            # window symbols t0..t0+3 for every candidate: slice
            # per + 3 prefetched rows (traced start, major axis — cheap)
            # and resolve each candidate's word-alignment offset with a
            # static (per-1)-way select
            blk = jax.lax.dynamic_slice_in_dim(
                wsymsT, t0, per + 3, axis=0
            )
            syms = []
            for k in range(4):
                sym = blk[k]
                for j in range(1, per):
                    sym = jnp.where(offp == j, blk[k + j], sym)
                syms.append(sym)
        reps = []
        sts = []
        for k in range(4):
            state, rep = step(state, t0 + k, syms[k])
            reps.append(rep)
            sts.append(state)
        return state, (jnp.stack(reps), jnp.stack(sts))

    ts0 = (
        jax.lax.broadcasted_iota(jnp.int32, (WLp // 4, 1), 0).squeeze(-1) * 4
    )
    _, (rep_all, st_all) = jax.lax.scan(
        body, jnp.zeros((kw,), jnp.int32), ts0
    )
    rep_all = rep_all.reshape(WLp, kw)  # [t, cand]
    st_all = st_all.reshape(WLp, kw)

    if stages <= 3:  # bench hook: walk done, no event compaction
        meta = jnp.stack([
            jnp.sum(rep_all.astype(jnp.int32)),
            jnp.zeros((), jnp.int32),
            jnp.minimum(n_cand, INT32_MAX),
            base_flags,
            jnp.minimum(n_exact, INT32_MAX),
        ])
        return (
            meta,
            jnp.zeros((3, k_ev), jnp.int32),
            jnp.zeros((num_groups,), jnp.int32),
        )

    # ---- stage 4: event compaction ((cand, t) order == (lane, end) order:
    # per-candidate keep intervals are disjoint and ascend within a lane) --
    rep_cm = rep_all.T.reshape(-1)  # [kw * WLp]
    st_cm = st_all.T.reshape(-1)
    t_of = jnp.broadcast_to(
        jax.lax.broadcasted_iota(jnp.int32, (1, WLp), 1), (kw, WLp)
    ).reshape(-1)
    e_cm = (w0[:, None] + jnp.zeros((1, WLp), jnp.int32)).reshape(-1) + t_of
    lane_cm = jnp.broadcast_to(lane[:, None], (kw, WLp)).reshape(-1)
    n_ev, (ev_lane, ev_end, ev_state), ev_over = _compact_flags(
        rep_cm,
        [
            (lane_cm, jnp.int32(-1)),
            (e_cm, jnp.int32(-1)),
            (st_cm, jnp.int32(0)),
        ],
        k_ev,
    )

    if stages <= 4:  # bench hook: events compacted, no group counts
        meta = jnp.stack([
            n_ev,
            jnp.minimum(n_ev, k_ev),
            jnp.minimum(n_cand, INT32_MAX),
            base_flags | (ev_over.astype(jnp.int32) << 1),
            jnp.minimum(n_exact, INT32_MAX),
        ]).astype(jnp.int32)
        return (
            meta,
            jnp.stack([ev_lane, ev_end, ev_state]),
            jnp.zeros((num_groups,), jnp.int32),
        )

    # ---- stage 5: per-group counts (psum-able) ----------------------------
    # Counted from the COMPACTED events: a state_gid gather over the full
    # [k_cand * WLp] report stream costs ~13 ns/element serialized (2+ ms
    # at official shapes); over k_ev slots it is ~0.1 ms. Exact whenever
    # n_ev <= k_ev — guaranteed on the session path (capacity retry uses
    # the exact n_ev), flagged loudly (bit1) on the fixed-capacity mesh
    # step.
    reported = jnp.minimum(n_ev, k_ev)
    slot_ev = jax.lax.broadcasted_iota(jnp.int32, (k_ev, 1), 0).squeeze(-1)
    live_ev = slot_ev < reported
    gid_ev = jnp.take(state_gid, ev_state, mode="clip")
    gidx = jnp.where(live_ev, gid_ev, G)
    gcounts = (
        jnp.zeros((G,), jnp.int32)
        .at[gidx]
        .add(live_ev.astype(jnp.int32), mode="drop")
    )
    flags = base_flags | (ev_over.astype(jnp.int32) << 1)
    meta = jnp.stack(
        [n_ev, reported, jnp.minimum(n_cand, INT32_MAX), flags,
         jnp.minimum(n_exact, INT32_MAX)]
    ).astype(jnp.int32)
    packed = jnp.stack([ev_lane, ev_end, ev_state])
    return meta, packed, gcounts


_verify_jit = jax.jit(
    _verify_kernel,
    static_argnames=(
        "alphabet_size",
        "stride",
        "q",
        "lmax",
        "halo",
        "k_cand",
        "k_ev",
        "num_groups",
        "exact_meta",
        "k_walk",
        "prefetch_windows",
        "stages",
    ),
)


MAX_DEVICE_CAND = 1 << 17  # past this, host verify is the better tool
# (match-saturated input: the host walker's merged windows collapse the
# work; the device path would walk k_cand * WL with no merging)


class DeviceVerifier:
    """Session-side wrapper: ships the dense table once, buckets capacities.

    ``verify(data, bounds, bits, total)`` dispatches with the next
    bucketed candidate capacity >= the probe's exact survivor total
    (so candidate overflow cannot happen) and retries event capacity on
    the exact overflow count reported back. Returns host numpy
    (meta, packed, gcounts) — exactly two D2H transfers in the common case.
    """

    def __init__(self, table, cfg, halo: int, sharding=None,
                 gram_keys=None):
        put = (
            (lambda x: jax.device_put(x, sharding))
            if sharding is not None
            else jax.device_put
        )
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
        # exact-gram refinement (ops/exact_gram.py): erase bloom fp
        # candidates with ~0.1 us/slot before the ~0.7 us/slot walk.
        # ``gram_keys`` is the builder's exact inserted set
        # (BloomFilterTable.gram_keys); None (pre-refinement filter
        # dumps) runs the unrefined pipeline.
        self.exact_lo = self.exact_hi = None
        self.exact_meta = None
        self._k_walk = 256  # sticky refined-capacity bucket
        if gram_keys is not None and len(gram_keys):
            from .exact_gram import table_from_keys

            xt = table_from_keys(
                gram_keys, cfg.q,
                bits=(table.alphabet_size - 1).bit_length(),
            )
            self.exact_lo = put(xt.lo.view(np.int32))
            self.exact_hi = (
                put(xt.hi.view(np.int32)) if xt.use_hi else None
            )
            self.exact_meta = xt.device_meta(cfg.fold_case)

    def _dispatch(self, data, bounds, bits, k_cand: int, k_ev: int,
                  k_walk: int):
        return _verify_jit(
            self.table_flat,
            self.state_gid,
            data,
            bounds,
            bits,
            self.exact_lo,
            self.exact_hi,
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

    def verify(
        self, data, bounds, bits, total: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(meta, packed[:, :reported], gcounts) as host arrays; raises
        RuntimeError when ``total`` exceeds the device-verify cap (the
        caller falls back to host verify — loud, never silent loss)."""
        if total > MAX_DEVICE_CAND:
            raise RuntimeError(
                f"{total} candidates exceed the device-verify cap "
                f"{MAX_DEVICE_CAND}; use host verify for this batch"
            )
        k_cand = next_cap(total)
        if self.exact_meta is None:
            k_walk = k_ev = k_cand
        else:
            k_walk = k_ev = min(k_cand, self._k_walk)
        meta_d, packed_d, gc_d = self._dispatch(
            data, bounds, bits, k_cand, k_ev, k_walk
        )
        meta = np.asarray(meta_d)
        if meta[3] & 4:  # refine overflow: retry with the exact need
            k_walk = k_ev = min(k_cand, next_cap(int(meta[4])))
            meta_d, packed_d, gc_d = self._dispatch(
                data, bounds, bits, k_cand, k_ev, k_walk
            )
            meta = np.asarray(meta_d)
        if meta[3] & 2:  # event overflow: retry with the exact need
            k_ev = next_cap(int(meta[0]))
            meta_d, packed_d, gc_d = self._dispatch(
                data, bounds, bits, k_cand, k_ev, k_walk
            )
            meta = np.asarray(meta_d)
        if self.exact_meta is not None:
            # adapt the sticky refined bucket to what this batch needed
            self._k_walk = next_cap(int(meta[4]))
        if meta[3] & 1:
            raise RuntimeError(
                "device verify candidate overflow with a bucketed "
                "capacity — probe total and bitmap disagree (bug)"
            )
        reported = int(meta[1])
        packed = np.asarray(packed_d)[:, :reported]
        return meta, packed, np.asarray(gc_d)
