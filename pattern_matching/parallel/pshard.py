"""Pattern-set sharding — the model-parallel axis of the matcher.

The data-parallel layout (parallel/mesh.py) replicates the whole filter
and shards input lanes; that is the reference's N-workers-per-device
story (ocl_aho_grep.c:494-502) scaled to a mesh. This module adds the
axis the reference never had (SURVEY.md section 2.5 names it the
CP-analogue): partition the PATTERN SET into S shards, give each shard
its own (much less loaded) bloom filter — and, for the all-device count
path, its own (HBM-sized) DFA table.

Why this exists: a single filter saturates between 300k patterns (fp
1.6e-2 at v=128) and 1M (fp 1.25e-2 at the k=9 x v=256 capacity
ceiling), and the 1M dense table is 10.3 GB — a large share of one
device's memory to replicate on every device. Sharding S ways divides the gram load, the fp, the probe depth, and the table per
chip by ~S: each shard's filter is chosen for G/S grams, which rides the
~1/G scale curve back up.

Exactness is unchanged: a position is a candidate iff SOME shard's
filter accepts its gram, so the shard survivor bitmaps OR together
(on device — one ``[W, C]`` bitmap comes back regardless of S) and the
existing verify stages (host native walker, device windowed walk) run
on the union exactly as for one filter. Co-terminating patterns that
land in different shards still merge into one event, because
verification is against the global pattern set.

Two execution shapes:

- **single device** (``MatchSession(pat_shards=S)`` with no mesh): the
  S probes run inside one jit and OR on device — a pure filter-capacity
  feature (S small filters replace one saturated big one).
- **2D mesh** ``("pat", "data")`` (``pat_shards=S`` with ``mesh=``):
  shard s's filter lives only on the pat=s row of the mesh; input lanes
  shard over "data"; each device probes (its pattern shard x its lane
  shard); bitmaps ``all_gather`` over "pat" (a few MB) and OR,
  so every data column holds the union bitmap. The count path walks the
  union against each shard's OWN table (sharded over "pat") and psums
  per-group counts over "data" — per-PATTERN counts are exact, with
  1/S of the table per chip.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pattern_matching.ops.bloom import (
    BloomConfig,
    BloomFilterTable,
    BloomHits,
    _probe_bits_jit,
    config_arrays,
    config_from_arrays,
)


def shard_pattern_ids(lengths, n_shards: int) -> list[np.ndarray]:
    """Partition pattern ids into balanced shards: deal longest-first
    round-robin, so gram load and max_pat_len stay even and the globally
    shortest pattern (which constrains the common q/stride/w choice)
    lands in the LAST shard."""
    order = np.argsort(-np.asarray(lengths), kind="stable")
    return [np.sort(order[s::n_shards]) for s in range(n_shards)]


@dataclasses.dataclass
class ShardedBloom:
    """S per-shard filters under ONE common BloomConfig (a single kernel
    shape probes any shard). Duck-types the BloomFilterTable surface the
    session touches (cfg / max_pat_len / put / save)."""

    words: np.ndarray  # [S, kbanks, v, 128] int32
    cfg: BloomConfig
    parts: list[np.ndarray]  # global pattern ids per shard
    max_pat_len: int  # global (over all shards)
    n_grams: list[int]  # per shard
    fp_est: list[float]  # per shard
    shard_gram_keys: list | None = None  # per-shard exact inserted gram
    # keys (sorted uint64 arrays, ops/exact_gram.pack_grams layout) —
    # the pat-sharded count step refines each device's walk against ITS
    # shard's set (erasing other shards' true grams too)

    @property
    def n_shards(self) -> int:
        return len(self.parts)

    @property
    def gram_keys(self):
        """UNION of the per-shard inserted gram sets: a union-bitmap
        candidate is true iff its gram is in SOME shard's set, so one
        exact table over the union refines the union bitmap (the
        single-device / host-verify shape)."""
        if self.shard_gram_keys is None:
            return None
        return np.unique(np.concatenate(self.shard_gram_keys))

    @staticmethod
    def from_table(table, n_shards: int, **kw) -> "ShardedBloom":
        return ShardedBloom.build(
            [p.symbols for p in table.patterns],
            n_shards,
            fold_case=getattr(table, "nocase", False),
            # alphabet width must ride along or a 2048-alphabet (ushort)
            # sharded build would pack 11-bit symbols into 8-bit gram keys
            alphabet_size=table.alphabet_size,
            **kw,
        )

    @staticmethod
    def build(
        patterns,
        n_shards: int,
        *,
        fold_case: bool = False,
        **build_opts,
    ) -> "ShardedBloom":
        """Partition + choose ONE config + build S filters.

        The chooser runs once, on the shard holding the globally shortest
        pattern (its length constraints bind every legal config; shards
        are gram-balanced, so its load is representative), with
        ``rate_scale=S`` so verify pricing and eligibility see the UNION
        candidate rate — per-shard fp sums over S shards while probe cost
        per chip stays per-shard on the ("pat","data") mesh. The other
        shards build with ``force=`` pinning the chosen
        (mode, q, stride/w, k, v); the shared seed makes the hash mixes
        identical, which the build asserts.
        """
        pats = [list(p) for p in patterns]
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if n_shards > len(pats):
            raise ValueError(
                f"{n_shards} shards for {len(pats)} patterns; "
                f"shards must be non-empty"
            )
        parts = shard_pattern_ids([len(p) for p in pats], n_shards)
        # the chooser shard: longest-first dealing puts the globally
        # shortest pattern (dealt last) in shard (N-1) mod S — its length
        # constraints bind every legal (q, stride/w) choice
        chooser = (len(pats) - 1) % n_shards
        build_opts.setdefault("rate_scale", float(n_shards))
        first = BloomFilterTable.build(
            [pats[i] for i in parts[chooser]],
            fold_case=fold_case,
            **build_opts,
        )
        cfg = first.cfg
        force = (
            ("sampled", cfg.q, cfg.w, cfg.kbanks, cfg.v)
            if cfg.sampled
            else ("strided", cfg.q, cfg.stride, cfg.kbanks, cfg.v)
        )
        shards: list[BloomFilterTable] = [None] * n_shards  # type: ignore
        shards[chooser] = first
        for s in range(n_shards):
            if s == chooser:
                continue
            shards[s] = BloomFilterTable.build(
                [pats[i] for i in parts[s]],
                fold_case=fold_case,
                force=force,
                **build_opts,
            )
            if shards[s].cfg != cfg:  # same seed -> same mixes; verify
                raise AssertionError(
                    f"shard {s} config diverged: {shards[s].cfg} != {cfg}"
                )
        if all(sh.gram_keys is not None for sh in shards):
            shard_gram_keys = [sh.gram_keys for sh in shards]
        else:
            shard_gram_keys = None
        return ShardedBloom(
            words=np.stack([sh.words for sh in shards]),
            cfg=cfg,
            parts=parts,
            max_pat_len=max(len(p) for p in pats),
            n_grams=[sh.n_grams for sh in shards],
            fp_est=[sh.fp_est for sh in shards],
            shard_gram_keys=shard_gram_keys,
        )

    def put(self, sharding=None) -> "DeviceShardedBloom":
        put = (
            (lambda x: jax.device_put(x, sharding))
            if sharding is not None
            else jax.device_put
        )
        return DeviceShardedBloom(
            words=put(self.words), cfg=self.cfg, max_pat_len=self.max_pat_len
        )

    # -- serialization (same compiled-filter dump family as the flat
    # filter: plain arrays only, no pickle) --------------------------------

    def save(self, path: str) -> None:
        plen = np.asarray([len(p) for p in self.parts], np.int64)
        np.savez_compressed(
            path,
            pshard_words=self.words,
            **config_arrays(self.cfg),
            max_pat_len=np.int64(self.max_pat_len),
            part_lens=plen,
            part_ids=np.concatenate(
                [np.asarray(p, np.int64) for p in self.parts]
            ),
            n_grams=np.asarray(self.n_grams, np.int64),
            fp_est=np.asarray(self.fp_est, np.float64),
            **(
                {
                    "gram_keys_flat": np.concatenate(self.shard_gram_keys),
                    "gram_keys_lens": np.asarray(
                        [len(k) for k in self.shard_gram_keys], np.int64
                    ),
                }
                if self.shard_gram_keys is not None
                else {}
            ),
        )

    @staticmethod
    def load(path: str) -> "ShardedBloom":
        z = np.load(path)
        if "pshard_words" not in z:
            raise ValueError(
                f"{path} is a flat filter dump, not a sharded one "
                f"(load with BloomFilterTable.load)"
            )
        cfg = config_from_arrays(z, path)
        plen = z["part_lens"]
        flat = z["part_ids"]
        parts, off = [], 0
        for n in plen:
            parts.append(flat[off : off + int(n)].copy())
            off += int(n)
        shard_gram_keys = None
        if "gram_keys_flat" in z.files:
            kf = z["gram_keys_flat"]
            shard_gram_keys, off = [], 0
            for n in z["gram_keys_lens"]:
                shard_gram_keys.append(kf[off : off + int(n)].copy())
                off += int(n)
        return ShardedBloom(
            words=z["pshard_words"],
            cfg=cfg,
            parts=parts,
            max_pat_len=int(z["max_pat_len"]),
            n_grams=[int(x) for x in z["n_grams"]],
            fp_est=[float(x) for x in z["fp_est"]],
            shard_gram_keys=shard_gram_keys,
        )


@functools.partial(jax.jit, static_argnames=("cfg", "n_shards"))
def _sharded_hits_jit(data, bounds, words, *, cfg, n_shards):
    """S probes + on-device OR: lane-major data in, ONE union bitmap out.

    Each shard's probe produces its own [W, C] bitmap and the maps OR — a
    position is a candidate iff some shard accepts it. ``total`` is the
    popcount of the union: the exact candidate count the decode stage
    will walk (duplicates across shards never exist)."""
    bits = None
    for s in range(n_shards):
        b = _probe_bits_jit(data, bounds, words[s], cfg=cfg)
        bits = b if bits is None else (bits | b)
    total = jnp.sum(jax.lax.population_count(bits))
    return total.reshape(1), bits


@dataclasses.dataclass
class DeviceShardedBloom:
    """Device-side sharded filter with the DeviceBloom probe surface."""

    words: jax.Array  # [S, k, v, 128] int32
    cfg: BloomConfig
    max_pat_len: int

    def hits(self, data, bounds) -> BloomHits:
        meta, bits = _sharded_hits_jit(
            data, bounds, self.words,
            cfg=self.cfg,
            n_shards=int(self.words.shape[0]),
        )
        return BloomHits(meta=meta, bits=bits)

    def probe_total(self, data, start_t, end_t, halo: int = 0):
        """Benchmark hook: union survivor total (forces all S probes)."""
        meta, _ = _sharded_hits_jit(
            data,
            jnp.stack([start_t, end_t]),
            self.words,
            cfg=self.cfg,
            n_shards=int(self.words.shape[0]),
        )
        return meta[0]


# ------------------------------------------------------------- 2D mesh path


@dataclasses.dataclass
class Mesh2DContext:
    """("pat", "data") mesh: shard s's filter row x lane columns."""

    mesh: Mesh

    @staticmethod
    def build(devices, n_shards: int) -> "Mesh2DContext":
        """Arrange devices into the ("pat", "data") grid so every DATA
        COLUMN's S pat rows live on ONE process.

        This is what lets pattern shards compose with multi-process
       : batch lanes shard ``P("data")`` and replicate
        over "pat", so the process feeding a lane block must own all the
        devices that hold it — otherwise every host would have to read
        the whole corpus and input bandwidth could not scale with hosts
        (the same argument as the 1D multi-host layout). Per process the
        local devices fill pat-major, giving contiguous per-process data
        columns (the contiguity the host-local bitmap/event decode
        relies on). Single-process this reduces to the plain
        ``reshape(n_shards, -1)``.
        """
        devices = np.asarray(devices).reshape(-1)
        if len(devices) % n_shards:
            raise ValueError(
                f"{len(devices)} devices do not split into {n_shards} "
                f"pattern shards"
            )
        procs: dict[int, list] = {}
        for d in devices:
            procs.setdefault(int(d.process_index), []).append(d)
        cols = []
        for p in sorted(procs):
            local = procs[p]
            if len(local) % n_shards:
                raise ValueError(
                    f"process {p} has {len(local)} devices — not "
                    f"divisible by {n_shards} pattern shards (each "
                    f"process must host all S pat rows of its data "
                    f"columns)"
                )
            col = np.empty((n_shards, len(local) // n_shards), object)
            for i, d in enumerate(local):
                col[i // (len(local) // n_shards),
                    i % (len(local) // n_shards)] = d
            cols.append(col)
        grid = np.concatenate(cols, axis=1)
        return Mesh2DContext(Mesh(grid, ("pat", "data")))

    @property
    def n_shards(self) -> int:
        return self.mesh.shape["pat"]

    @property
    def data_size(self) -> int:
        return self.mesh.shape["data"]

    @property
    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())

    @property
    def pat_sharded(self) -> NamedSharding:
        return NamedSharding(self.mesh, P("pat"))

    @property
    def lane_sharded(self) -> NamedSharding:
        # [C, T] batches: lanes over "data", replicated over "pat"
        return NamedSharding(self.mesh, P("data"))

    @property
    def lane_sharded2d(self) -> NamedSharding:
        return NamedSharding(self.mesh, P(None, "data"))


def make_pattern_sharded_bloom_step(ctx: Mesh2DContext, dev: DeviceShardedBloom):
    """The 2D-mesh probe: device (s, d) probes shard s's filter over lane
    shard d, bitmaps all_gather over "pat" (W x C_local x 4 bytes — a few
    MB) and OR, so the union bitmap is data-column-replicated and
    the session's shard-aware host decode (_candidate_rows) reads each
    column once. Survivor total psums over "data" on the union — exact,
    duplicate-free, identical to the single-device union."""
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    from pattern_matching.ops.bloom import _hits_jit

    cfg = dev.cfg

    def local_step(words, data, bounds):
        C_local = data.shape[0]
        if C_local % 128:
            raise ValueError(
                f"per-device lane count {C_local} must be a multiple of "
                f"128 (pad the batch to data_size*128 lanes)"
            )
        _t, bits = _hits_jit(
            data, bounds, words[0], cfg=cfg,
        )
        bits_all = jax.lax.all_gather(bits, "pat")  # [S, W, C_local]
        union = jax.lax.reduce(
            bits_all, np.int32(0), jax.lax.bitwise_or, (0,)
        )
        local = jnp.sum(jax.lax.population_count(union)).reshape(1)
        # meta [2]: [global union total, MAX per-data-shard total] — the
        # second is the capacity bound the pat-sharded device-verify
        # stage buckets with (PshardDeviceVerifier), mirroring the 1D
        # mesh step's convention (mesh.make_sharded_bloom_step)
        meta = jnp.concatenate(
            [jax.lax.psum(local, "data"), jax.lax.pmax(local, "data")]
        )
        return meta, union

    return jax.jit(
        shard_map(
            local_step,
            mesh=ctx.mesh,
            in_specs=(P("pat"), P("data"), P(None, "data")),
            out_specs=(P(), P(None, "data")),
            check_vma=False,  # the all_gather+OR over "pat" replicates
            # the union; replication inference cannot see through the OR
        )
    )


# -------------------------------------------------- all-device count path


def pad_shard_tables(tables) -> tuple[np.ndarray, np.ndarray, int, int]:
    """Stack per-shard dense tables for shard_map: [S, states_max * A]
    signed goto rows and [S, states_max] state->group ids, zero-padded
    (padded states are unreachable: walks start at state 0 of each
    shard's own automaton). Returns (table_flat, state_gid, lmax, gmax)."""
    A = tables[0].alphabet_size
    smax = max(t.num_states for t in tables)
    S = len(tables)
    flat = np.zeros((S, smax * A), np.int32)
    gids = np.zeros((S, smax), np.int32)
    for s, t in enumerate(tables):
        flat[s, : t.num_states * A] = np.ascontiguousarray(
            t.goto_signed
        ).reshape(-1)
        gids[s, : t.num_states] = t.state_gid.astype(np.int32)
    lmax = max(t.max_pat_len for t in tables)
    gmax = max(t.num_groups for t in tables)
    return flat, gids, lmax, gmax


def make_pattern_sharded_count_step(
    ctx: Mesh2DContext,
    dev: DeviceShardedBloom,
    shard_tables,
    *,
    halo: int,
    k_cand: int = 4096,
    k_ev: int = 4096,
    shard_gram_keys=None,
    k_walk: int | None = None,
):
    """Probe + device verify + count, with the TABLE sharded over "pat".

    Each device walks the UNION candidate bitmap against its own shard's
    dense table (1/S of the global table per device — at 1M patterns the
    global table is 10.3 GB) and accumulates per-group counts for
    its shard; counts psum over "data" and stack over "pat".

    Returns ``step(words, table_flat, state_gid, data, bounds) ->
    (gcounts [S, Gmax], n_events [S], flags [S])`` — all replicated.
    Per-shard event totals are exact; map gcounts to global per-PATTERN
    counts with :func:`global_pattern_counts`. ``flags[s] != 0`` means
    shard s overflowed a static capacity (bit0 candidates, bit1 event
    slots) and its row is incomplete — rescan with larger caps. Note the
    event-per-end semantics are per SHARD: patterns co-terminating across
    shards count one event in each shard's total (per-pattern counts are
    unaffected; the event-set decode path merges them instead).

    ``shard_gram_keys`` (list of per-shard BloomFilterTable.gram_keys
    sets — pass ShardedBloom per-shard keys, NOT the union) enables
    per-shard exact-gram refinement: each device erases every union
    candidate whose gram is not in ITS OWN shard's inserted set — both
    bloom fp AND other shards' true grams die before the walk, so the
    per-device walk load is the per-shard rate, not the S-fold union
    flood. Exactness per shard follows the
    usual candidate-subset argument applied shard-wise: every occurrence
    of a shard-s pattern contains a probed gram from shard s's set."""
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    from pattern_matching.ops.bloom import _hits_jit
    from pattern_matching.ops.verify_device import _verify_kernel

    cfg = dev.cfg
    alphabet_size = shard_tables[0].alphabet_size
    lmax = max(t.max_pat_len for t in shard_tables)
    gmax = max(t.num_groups for t in shard_tables)
    exact_meta = None
    exact_lo_s = exact_hi_s = None
    if shard_gram_keys is not None:
        from pattern_matching.ops.exact_gram import (
            tables_from_keys_common,
        )

        xts = tables_from_keys_common(
            shard_gram_keys, cfg.q,
            bits=(alphabet_size - 1).bit_length(),
        )
        x0 = xts[0]
        # shared static meta across shards: n differs per shard and is
        # only consumed by the n==0 early-out, so min() is the safe pick
        exact_meta = (x0.dmax, x0.m, x0.c1, x0.c2,
                      min(t.n for t in xts), bool(cfg.fold_case),
                      x0.use_hi, x0.bits)
        pat_sh = jax.sharding.NamedSharding(
            ctx.mesh, P("pat") if ctx.mesh.shape["pat"] > 1 else P()
        )
        exact_lo_s = jax.device_put(
            np.stack([t.lo.view(np.int32) for t in xts]), pat_sh
        )
        exact_hi_s = (
            jax.device_put(
                np.stack([t.hi.view(np.int32) for t in xts]), pat_sh
            )
            if x0.use_hi
            else None
        )
    kw = k_walk if k_walk is not None else k_cand

    def local_step(words, table_flat, state_gid, exact_lo, exact_hi,
                   data, bounds):
        C_local = data.shape[0]
        if C_local % 128:
            raise ValueError(
                f"per-device lane count {C_local} must be a multiple of "
                f"128 (pad the batch to data_size*128 lanes)"
            )
        _t, bits = _hits_jit(
            data, bounds, words[0], cfg=cfg,
        )
        bits_all = jax.lax.all_gather(bits, "pat")
        union = jax.lax.reduce(
            bits_all, np.int32(0), jax.lax.bitwise_or, (0,)
        )
        meta, _packed, gcounts = _verify_kernel(
            table_flat[0],
            state_gid[0],
            data,
            bounds,
            union,
            exact_lo[0] if exact_lo is not None else None,
            exact_hi[0] if exact_hi is not None else None,
            alphabet_size=alphabet_size,
            stride=cfg.stride,
            q=cfg.q,
            lmax=lmax,
            halo=halo,
            k_cand=k_cand,
            k_ev=k_ev,
            num_groups=gmax,
            exact_meta=exact_meta,
            k_walk=kw,
        )
        # flags are a BITMASK: reduce with a bitwise OR over "data" (a
        # psum would alias bits — two lane shards with bit0 sum to bit1).
        # pmax per extracted bit == OR for 0/1 values.
        flags_or = (
            jax.lax.pmax(meta[3] & 1, "data")
            | jax.lax.pmax(meta[3] & 2, "data")
            | jax.lax.pmax(meta[3] & 4, "data")
        )
        return (
            jax.lax.psum(gcounts, "data")[None],
            jax.lax.psum(meta[0], "data")[None],
            flags_or[None],
        )

    jitted = jax.jit(
        shard_map(
            local_step,
            mesh=ctx.mesh,
            in_specs=(P("pat"), P("pat"), P("pat"),
                      P("pat") if exact_lo_s is not None else P(),
                      P("pat") if exact_hi_s is not None else P(),
                      P("data"), P(None, "data")),
            out_specs=(P("pat", None), P("pat"), P("pat")),
            check_vma=False,  # the all_gather+OR over "pat" replicates
            # the union; replication inference cannot see through the OR
        )
    )

    def step(words, table_flat, state_gid, data, bounds):
        return jitted(words, table_flat, state_gid, exact_lo_s,
                      exact_hi_s, data, bounds)

    return step


class PshardDeviceVerifier:
    """Device-exact EVENTS with the TABLE sharded over "pat".

    The last configuration where the reference's in-kernel emission
    (ahomatch.cl:63-74: exact ``(pattern_id, offset)`` tuples from the
    device in every run mode) had no counterpart here: verbose grep on
    the ("pat", "data") mesh previously had to verify host-side against
    the GLOBAL pattern set — at the 1M-pattern scale this grid exists
    for, that host walk was the one non-sharded stage left.

    This is the event-emitting sibling of
    :func:`make_pattern_sharded_count_step`: device (s, d) walks the
    union candidate bitmap of ITS lane shard against shard s's OWN dense
    table (1/S of the global table per chip), refined by shard s's OWN
    exact-gram set (both bloom fp and other shards' true grams die
    before the walk), and emits packed ``(lane, end, state)`` tuples
    sharded over BOTH mesh axes. Exactness per shard is the count step's
    candidate-subset argument; the union across shards of the per-shard
    event sets at one (lane, end) is the global co-terminating pattern
    set, so the host-side merge (session._merge_pshard_events) keys on
    (lane, end) and unions the shard groups' pattern ids.

    Multi-process: ``Mesh2DContext.build`` keeps every data column's S
    pat rows on ONE process, so each host's ``addressable_shards`` cover
    all S shard blocks of its own lanes — events stay host-local, no
    cross-DCN event gather (the same layout argument as the bitmap
    decode and :class:`~pattern_matching.parallel.mesh.MeshDeviceVerifier`).

    Capacity/retry protocol mirrors MeshDeviceVerifier: static bucketed
    capacities, replicated ``needs`` (SPMD-safe identical retry decision
    on every process), log-bounded recompiles.
    """

    def __init__(self, ctx: Mesh2DContext, sharded: ShardedBloom,
                 shard_tables, halo: int):
        self.ctx = ctx
        self.shard_tables = shard_tables
        cfg = sharded.cfg
        flat, gids, lmax, gmax = pad_shard_tables(shard_tables)
        pat_sh = ctx.pat_sharded
        self.table_flat = jax.device_put(flat, pat_sh)
        self.state_gid = jax.device_put(gids, pat_sh)
        self.alphabet_size = shard_tables[0].alphabet_size
        self.lmax = lmax
        self.gmax = gmax
        self.stride = cfg.stride
        self.q = cfg.q
        self.halo = halo
        self._k_walk = 256  # sticky refined-capacity bucket (SPMD-safe)
        self._steps: dict[tuple[int, int, int], object] = {}
        # host-side decode tables: shard-local state -> shard group ->
        # GLOBAL pattern ids (via the shard's id map)
        self.shard_state_gid_host = [t.state_gid for t in shard_tables]
        self.shard_groups_global = [
            [
                [int(part[pid]) for pid in pids]
                for pids in t.groups_as_lists()
            ]
            for t, part in zip(shard_tables, sharded.parts)
        ]
        self.exact_lo = self.exact_hi = None
        self.exact_meta = None
        keys = sharded.shard_gram_keys
        if keys is not None and all(len(k) for k in keys):
            from pattern_matching.ops.exact_gram import (
                tables_from_keys_common,
            )

            xts = tables_from_keys_common(
                keys, cfg.q,
                bits=(self.alphabet_size - 1).bit_length(),
            )
            x0 = xts[0]
            # shared static meta across shards (same rule as the count
            # step): n only feeds the n==0 early-out, so min() is safe
            self.exact_meta = (x0.dmax, x0.m, x0.c1, x0.c2,
                               min(t.n for t in xts),
                               bool(cfg.fold_case), x0.use_hi, x0.bits)
            self.exact_lo = jax.device_put(
                np.stack([t.lo.view(np.int32) for t in xts]), pat_sh
            )
            self.exact_hi = (
                jax.device_put(
                    np.stack([t.hi.view(np.int32) for t in xts]), pat_sh
                )
                if x0.use_hi
                else None
            )

    def _step(self, k_cand: int, k_ev: int, k_walk: int):
        key = (k_cand, k_ev, k_walk)
        if key in self._steps:
            return self._steps[key]
        try:
            from jax import shard_map
        except ImportError:  # older jax
            from jax.experimental.shard_map import shard_map

        from pattern_matching.ops.verify_device import _verify_kernel

        exact_meta = self.exact_meta
        both = ("pat", "data")

        def local_step(table_flat, state_gid, exact_lo, exact_hi,
                       data, bounds, bits):
            meta, packed, gcounts = _verify_kernel(
                table_flat[0],
                state_gid[0],
                data,
                bounds,
                bits,
                exact_lo[0] if exact_lo is not None else None,
                exact_hi[0] if exact_hi is not None else None,
                alphabet_size=self.alphabet_size,
                stride=self.stride,
                q=self.q,
                lmax=self.lmax,
                halo=self.halo,
                k_cand=k_cand,
                k_ev=k_ev,
                num_groups=self.gmax,
                exact_meta=exact_meta,
                k_walk=k_walk,
            )
            # flags are a BITMASK: OR across every device via per-bit pmax
            flags_or = (
                jax.lax.pmax(meta[3] & 1, both)
                | jax.lax.pmax(meta[3] & 2, both)
                | jax.lax.pmax(meta[3] & 4, both)
            )
            needs = jnp.stack(
                [
                    # global event ROWS (pre-merge: cross-shard
                    # co-terminators count once per shard — the host
                    # merge computes the exact event total)
                    jax.lax.psum(meta[0], both),
                    jax.lax.pmax(meta[0], both),  # max per-device events
                    jax.lax.pmax(meta[4], both),  # max per-device refined
                    flags_or,
                ]
            )
            return (
                needs,
                meta[None, None],
                packed[None, None],
                jax.lax.psum(gcounts, "data")[None],
            )

        step = jax.jit(
            shard_map(
                local_step,
                mesh=self.ctx.mesh,
                in_specs=(P("pat"), P("pat"),
                          P("pat") if self.exact_lo is not None else P(),
                          P("pat") if self.exact_hi is not None else P(),
                          P("data"), P(None, "data"), P(None, "data")),
                out_specs=(P(), P("pat", "data", None),
                           P("pat", "data", None, None), P("pat", None)),
                check_vma=False,  # the all_gather+OR over "pat"
                # replicates the union; inference cannot see through it
            )
        )
        self._steps[key] = step
        return step

    def _assemble(self, metas, packed, C_local: int):
        """Host-local (shard, lane, end, state) arrays from the 2D-sharded
        packed tuples: device (s, d)'s block rebases local lane ids by
        d * C_local, then by this host's first lane — valid because each
        process's data columns are contiguous in device order
        (Mesh2DContext.build packs per-process devices pat-major)."""
        per_meta: dict[tuple[int, int], np.ndarray] = {}
        for sh in metas.addressable_shards:
            s = sh.index[0].start or 0
            d = sh.index[1].start or 0
            per_meta[(s, d)] = np.asarray(sh.data)[0, 0]
        shards, lanes, ends, states = [], [], [], []
        seen: set[tuple[int, int]] = set()
        cols: set[int] = set()
        for sh in packed.addressable_shards:
            s = sh.index[0].start or 0
            d = sh.index[1].start or 0
            if (s, d) in seen:
                continue
            seen.add((s, d))
            cols.add(d)
            rep = int(per_meta[(s, d)][1])
            if not rep:
                continue
            blk = np.asarray(sh.data)[0, 0][:, :rep]
            shards.append(np.full(rep, s, np.int64))
            lanes.append(blk[0].astype(np.int64) + d * C_local)
            ends.append(blk[1].astype(np.int64))
            states.append(blk[2].astype(np.int64))
        lane0 = min(cols) * C_local if cols else 0
        if not lanes:
            z = np.zeros(0, np.int64)
            return z, z, z, z
        return (
            np.concatenate(shards),
            np.concatenate(lanes) - lane0,
            np.concatenate(ends),
            np.concatenate(states),
        )

    def verify(self, data, bounds, bits, total_max: int):
        """(shards, lanes, ends, states, gcounts): per-shard device event
        rows for THIS HOST's lanes (merge them with
        session._merge_pshard_events) + per-shard group counts [S, Gmax]
        psum-reduced over "data". Raises RuntimeError past
        MAX_DEVICE_CAND per data shard (caller falls back to host
        verify — loud, lossless). SPMD: call in lockstep everywhere."""
        from pattern_matching.ops.verify_device import (
            MAX_DEVICE_CAND,
            next_cap,
        )

        if total_max > MAX_DEVICE_CAND:
            raise RuntimeError(
                f"{total_max} candidates on one lane shard exceed the "
                f"device-verify cap {MAX_DEVICE_CAND}; host verify "
                f"handles this batch"
            )
        C_local = data.shape[0] // self.ctx.data_size
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
                "pshard device verify candidate overflow with a bucketed "
                "capacity — probe max-total and bitmap disagree (bug)"
            )
        sh, ln, e, st = self._assemble(metas, packed, C_local)
        return sh, ln, e, st, np.asarray(gc)


def global_pattern_counts(
    sharded: ShardedBloom, shard_tables, gcounts
) -> np.ndarray:
    """Map per-shard per-group counts [S, Gmax] to global per-pattern
    counts [n_patterns]: shard-local group g expands to its member
    patterns, which translate through the shard's id map. Exact for every
    pattern (a pattern lives in exactly one shard)."""
    n_pats = sum(len(p) for p in sharded.parts)
    out = np.zeros(n_pats, np.int64)
    gcounts = np.asarray(gcounts)
    for s, t in enumerate(shard_tables):
        part = sharded.parts[s]
        for g, pids in enumerate(t.groups_as_lists()):
            c = int(gcounts[s, g])
            if c:
                for pid in pids:
                    out[part[pid]] += c
    return out
