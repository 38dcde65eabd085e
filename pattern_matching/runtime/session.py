"""Match session: compiled table + device engine + result decoding.

Counterpart of the reference's per-thread worker context (ocl_worker.c:20-185)
— except the DFA is compiled once and replicated to the mesh by sharding
annotation instead of being rebuilt per worker thread (SURVEY.md section 2.1).
"""

from __future__ import annotations

import dataclasses
import io
from typing import Iterator, Sequence

import numpy as np

from pattern_matching.core.dfa import DfaTable
from pattern_matching.ops.compact import CompactMatches, per_group_counts
from pattern_matching.ops.table import DeviceTable
from pattern_matching.runtime.buffers import DataBuffer, HostBatch, StreamState


@dataclasses.dataclass
class MatchEvent:
    """One decoded match: absolute END offset of the occurrence in its file,
    the full pattern-index set ending there, and the representative id.

    ``lane`` is the batch lane the match was found in (for context echo —
    the reference's callback receives the chunk id, ocl_aho_grep.c:272);
    ``gid`` is the match-group id (patterns co-terminating at the final
    state; -1 when unknown)."""

    file_id: int
    end_offset: int
    pattern_indices: list[int]
    rep_index: int
    lane: int = -1
    gid: int = -1

    def expand(self) -> Iterator[tuple[int, int]]:
        for p in self.pattern_indices:
            yield (self.end_offset, p)


@dataclasses.dataclass
class BatchMatches:
    """Host-decoded results of one batch."""

    events: list[MatchEvent]
    total: int  # exact device-side event count (incl. slot overflow)
    reported: int
    overflowed: bool
    group_counts: np.ndarray | None = None  # [G] int32 when requested
    # total already counts every process's lanes (mesh psum); per-host
    # totals must be summed across processes by the caller
    total_is_global: bool = False


class MatchSession:
    def __init__(
        self,
        table: DfaTable,
        max_chunks: int = 1024,
        chunk_len: int = 1024,
        max_results: int = 16,
        halo: int | None = None,
        sharding=None,
        sort: bool = False,
        engine: str = "auto",
        bloom_opts: dict | None = None,
        mesh=None,
        device=None,
        bloom_table=None,
        verify: str = "auto",
        pat_shards: int = 1,
    ):
        """``engine`` selects the device scan:

        - "bloom" — q-gram bloom filter probe + exact verify on the host
          (native walker) or on device (ops/bloom.py).
        - "dense" — XLA signed-table DFA walk, exact on device.
        - "auto" (default) — dense, unless ``pat_shards > 1`` asks for
          the sharded filter (bloom, byte alphabet).

        ``mesh`` turns on the data-parallel multi-chip path: lanes shard
        across the mesh, the filter/DFA table replicates, survivor totals
        psum-reduce (the capability the reference approximates with N
        worker threads each owning one device, ocl_aho_grep.c:494-502).
        Accepts a MeshContext, a Mesh, an int (first N devices), or
        "all". ``device`` selects a single device by index or handle (the
        reference's ``-D devpos``, ocl_context.c:18-85); mutually
        exclusive with ``mesh``.

        ``verify`` picks the bloom engine's exactness stage (ignored by the
        dense engine, which is exact on device already):

        - "host" — native C++ window walker on the host CPU
          (runtime/verify.py). Fastest single-chip when host cores are
          spare; the host becomes the scaling wall on big meshes.
        - "device" — candidate windows compact and walk the dense table ON
          DEVICE (ops/verify_device.py): exact (lane, end, state) events
          and per-group counts with zero host CPU in the verify loop — the
          capability ahomatch.cl:63-74 has in-kernel. Works single-chip
          AND on a data-parallel ``mesh=`` (the verify pipeline runs
          per shard under shard_map and events come back lane-sharded,
          host-local to the process that owns the lanes —
          parallel.mesh.MeshDeviceVerifier). Falls back to host verify
          loudly past MAX_DEVICE_CAND candidates per batch/shard
          (match-saturated input is the host walker's regime).
        - "auto" (default) — host.

        ``pat_shards=S`` partitions the PATTERN SET into S balanced
        shards, each with its own smaller bloom filter under one common
        config (parallel/pshard.py) — the capacity axis for 300k+
        pattern sets, where a single filter saturates. Shard bitmaps OR on device, so decode and verify
        see one union bitmap and event semantics are IDENTICAL to the
        unsharded engine. Without a mesh the S probes run sequentially
        in one jit; with ``mesh=`` the devices form a ("pat", "data")
        grid and each device probes only its shard's filter over its
        lane shard. Bloom engine only.
        """
        from pattern_matching.utils.common import pad_halo, roundup

        if engine == "auto":
            engine = (
                "bloom"
                if table.alphabet_size == 256 and pat_shards > 1
                else "dense"
            )
        if engine not in ("dense", "bloom"):
            raise ValueError(f"unknown engine {engine!r}")
        if verify not in ("auto", "host", "device"):
            raise ValueError(f"unknown verify mode {verify!r}")
        from pattern_matching.parallel.pshard import ShardedBloom

        if isinstance(bloom_table, ShardedBloom):
            if pat_shards not in (1, bloom_table.n_shards):
                raise ValueError(
                    f"pat_shards={pat_shards} but the precompiled filter "
                    f"has {bloom_table.n_shards} shards"
                )
            pat_shards = bloom_table.n_shards
        if pat_shards < 1:
            raise ValueError(f"pat_shards must be >= 1, got {pat_shards}")
        if pat_shards > 1 and engine != "bloom":
            raise ValueError(
                "pat_shards applies to the bloom engine (the dense walk "
                "has no filter to shard); pass engine='bloom'"
            )
        self.pat_shards = pat_shards
        self.engine = engine
        self.verify_mode = (
            "host" if verify == "auto" else verify
        ) if engine == "bloom" else "n/a"
        self._dvf = None
        self._dvf_mesh = None
        self.table = table
        self._bloom = None
        self._verifier = None
        self._mesh_ctx = None
        self._bloom_step = None
        self.device = None
        self.data_sharding = None
        bounds_sharding = None
        if mesh is not None and device is not None:
            raise ValueError("pass mesh= or device=, not both")
        self._pshard_ctx = None
        if mesh is not None:
            from pattern_matching.parallel.mesh import as_mesh_context

            ctx = as_mesh_context(mesh)
            self._mesh_ctx = ctx
            import jax

            if pat_shards > 1:
                from pattern_matching.parallel.pshard import (
                    Mesh2DContext,
                )

                # composes with multi-process: Mesh2DContext.build keeps
                # every data column's S pat rows on one process, so lane
                # ownership (P("data") blocks) stays host-contiguous and
                # the union bitmap decodes host-locally exactly as the
                # 1D mesh does (round 4; was NotImplementedError)
                ctx2 = Mesh2DContext.build(
                    ctx.mesh.devices.reshape(-1), pat_shards
                )
                self._pshard_ctx = ctx2
                if max_chunks % (ctx2.data_size * 128):
                    max_chunks = roundup(max_chunks, ctx2.data_size * 128)
                sharding = ctx2.pat_sharded  # the stacked filter words
                self.data_sharding = ctx2.lane_sharded
                bounds_sharding = ctx2.lane_sharded2d
            else:
                # per-shard lanes must stay 128-aligned for the bloom
                # bitmap's column->lane mapping (make_sharded_bloom_step);
                # dense lanes just need to divide evenly
                align = (
                    ctx.num_devices * 128
                    if engine == "bloom"
                    else ctx.num_devices
                )
                if max_chunks % align:
                    max_chunks = roundup(max_chunks, align)
                sharding = ctx.replicated
                self.data_sharding = ctx.lane_sharded
                bounds_sharding = ctx.lane_sharded2d
        elif device is not None:
            import jax

            self.device = (
                jax.devices()[device] if isinstance(device, int) else device
            )
            sharding = self.device
            self.data_sharding = self.device
            bounds_sharding = self.device
        self._bounds_sharding = bounds_sharding
        if engine == "bloom":
            from pattern_matching.ops.bloom import BloomFilterTable
            from pattern_matching.runtime.verify import Verifier

            # a precompiled filter (BloomFilterTable.load) skips the
            # chooser+insertion build — at 100k patterns that is ~20s of
            # winnowing/search per process (plus the AC table via
            # DfaTable.load, the full cold-start path is file reads only)
            if bloom_table is not None:
                bft = bloom_table
            elif pat_shards > 1:
                bft = ShardedBloom.from_table(
                    table, pat_shards, **(bloom_opts or {})
                )
            else:
                bft = BloomFilterTable.from_table(
                    table, **(bloom_opts or {})
                )
            self.bloom_table = bft
            self._bloom = bft.put(sharding)
            self._verifier = Verifier(
                [p.symbols for p in table.patterns],
                alphabet_size=table.alphabet_size,
                q=bft.cfg.q,
                max_pat_len=table.max_pat_len,
                fold_case=bft.cfg.fold_case,
                dense_table=table,  # fast native window walker
            )
            self.dev = None  # the big DFA table never ships to the device
            if self._pshard_ctx is not None:
                from pattern_matching.parallel.pshard import (
                    make_pattern_sharded_bloom_step,
                )

                self._bloom_step = make_pattern_sharded_bloom_step(
                    self._pshard_ctx, self._bloom
                )
            elif self._mesh_ctx is not None:
                from pattern_matching.parallel.mesh import (
                    make_sharded_bloom_step,
                )

                self._bloom_step = make_sharded_bloom_step(
                    self._mesh_ctx, self._bloom
                )
        else:
            self.dev = DeviceTable.put(table, sharding)
        base_halo = (table.max_pat_len - 1) if halo is None else halo
        # pad so the scan engine's 8-wide unroll divides the tile length
        self.halo = pad_halo(base_halo, chunk_len)
        self._dvf_pshard = None
        if self.verify_mode == "device":
            if self._pshard_ctx is not None:
                # device-exact EVENTS with the table sharded over "pat":
                # each device walks the union bitmap against its shard's
                # OWN 1/S dense table (compiled here from the shard's
                # global pattern ids); co-terminating events merge across
                # shards at host decode (_merge_pshard_events)
                from pattern_matching.core.dfa import AhoCorasick
                from pattern_matching.parallel.pshard import (
                    PshardDeviceVerifier,
                )

                shard_tables = []
                for part in self.bloom_table.parts:
                    ac = AhoCorasick(
                        table.alphabet_size,
                        nocase=getattr(table, "nocase", False),
                    )
                    for pid in part:
                        ac.add_pattern(table.patterns[pid].symbols)
                    shard_tables.append(ac.compile())
                self._dvf_pshard = PshardDeviceVerifier(
                    self._pshard_ctx, self.bloom_table, shard_tables,
                    self.halo,
                )
            elif self._mesh_ctx is not None:
                from pattern_matching.parallel.mesh import (
                    MeshDeviceVerifier,
                )

                self._dvf_mesh = MeshDeviceVerifier(
                    self._mesh_ctx, table, self.bloom_table.cfg,
                    self.halo, gram_keys=self.bloom_table.gram_keys,
                )
            else:
                from pattern_matching.ops.verify_device import (
                    DeviceVerifier,
                )

                self._dvf = DeviceVerifier(
                    table, self.bloom_table.cfg, self.halo, sharding,
                    gram_keys=self.bloom_table.gram_keys,
                )
        if (
            self._bloom is not None
            and self._bloom_step is None
            and self._dvf is None
            and hasattr(self._bloom, "attach_exact")
            and getattr(self.bloom_table, "gram_keys", None) is not None
            and len(self.bloom_table.gram_keys)
            and hasattr(self.bloom_table, "expected_cand_rate")
        ):
            # host-verify path: refine the survivor bitmap ON DEVICE with
            # the exact inserted gram set, so the host only ever walks
            # true gram occurrences (bloom fp never crosses the D2H or
            # touches a host core). The capacity bucket comes from the
            # chooser's modeled candidate rate with REFINE_HEADROOM slack
            # (the refine stage costs ~137 ns per capacity SLOT, so slack
            # is a per-batch tax — ops/bloom.py); overflow passes the
            # unrefined bitmap through (host absorbs, lossless).
            from pattern_matching.ops.bloom import REFINE_HEADROOM
            from pattern_matching.ops.verify_device import (
                MAX_DEVICE_CAND,
                next_cap,
            )

            batch_positions = max_chunks * (self.halo + chunk_len)
            rate = self.bloom_table.expected_cand_rate()
            k_ref = next_cap(
                int(
                    min(
                        MAX_DEVICE_CAND,
                        max(2048, REFINE_HEADROOM * rate * batch_positions),
                    )
                )
            )
            self._bloom.attach_exact(
                self.bloom_table.gram_keys, k_ref, sharding,
                bits=self.bloom_table.gram_bits,
            )
        self.max_chunks = max_chunks
        self.chunk_len = chunk_len
        self.max_results = max_results
        self.sort = sort
        self._dense_step = None
        if engine == "dense" and self._mesh_ctx is not None:
            # lane-sharded per-device compaction (round 5): result tuples
            # never leave their owner's lane shard, so each host decodes
            # exactly the lanes it fed — lifting the dense engine's
            # single-process restriction (the transplanted reference
            # design, ahomatch.cl, now runs on multi-process meshes too)
            from pattern_matching.parallel.mesh import (
                make_sharded_dense_step,
            )

            c_local = max_chunks // self._mesh_ctx.num_devices
            self._dense_step = make_sharded_dense_step(
                self._mesh_ctx,
                self.dev,
                halo=self.halo,
                max_results=max_results,
                num_groups=table.num_groups,
                capacity=min(c_local * max_results, 8192),
            )
        from pattern_matching.utils.debug import dprint

        dprint(
            1,
            "session: engine=%s chunks=%dx%d halo=%d mesh=%s device=%s",
            engine, max_chunks, chunk_len, self.halo,
            getattr(self._mesh_ctx, "mesh", None), self.device,
        )
        self._groups = table.groups_as_lists()
        self._gid_of_pidset = {
            tuple(sorted(pids)): g for g, pids in enumerate(self._groups)
        }

    # ------------------------------------------------------------- plumbing

    @property
    def local_chunks(self) -> int:
        """Lanes THIS PROCESS feeds per batch. Single-process: the full
        ``max_chunks``. On a multi-process mesh each host assembles only
        its own lane shard (disjoint input files via the process-aware
        feeder) and ``scan`` stitches the global array with
        ``jax.make_array_from_process_local_data`` — the multi-host input
        path (every host reading the whole corpus would mean input
        bandwidth does NOT scale with hosts)."""
        import jax

        return self.max_chunks // (
            jax.process_count() if self._mesh_ctx is not None else 1
        )

    def new_buffer(self) -> DataBuffer:
        """A batch buffer matching this session's symbol width: byte
        sessions get the binary/text DataBuffer, ushort-alphabet sessions
        the token-parsing UshortBuffer — so scan_stream/find work on flow
        text for metadata tables too. Sized to this process's lane shard
        (= max_chunks single-process)."""
        if self.table.alphabet_size != 256:
            from pattern_matching.runtime.buffers import UshortBuffer

            return UshortBuffer(self.local_chunks, self.chunk_len, self.halo)
        return DataBuffer(self.local_chunks, self.chunk_len, self.halo)

    def scan(self, batch: HostBatch):
        """Device scan + compaction (+ sort) of one batch — ONE dispatch.

        Returns CompactMatches (dense) or BloomHits (bloom). With a
        ``mesh``, lanes are sharded across it before dispatch and the bloom
        probe runs under shard_map with a psum-reduced survivor total."""
        import numpy as _np

        from pattern_matching.ops.compact import scan_and_compact

        data = batch.data
        bounds = _np.stack([batch.start_t, batch.end_t])
        if self.data_sharding is not None:
            import jax

            if self._mesh_ctx is not None and jax.process_count() > 1:
                # multi-process mesh: ``batch`` is THIS HOST's lane shard
                # (local_chunks lanes); the global array assembles from
                # per-process shards — no host ever materializes lanes it
                # didn't read. All processes must call scan() in lockstep
                # (SPMD); idle hosts pass an empty batch.
                data = jax.make_array_from_process_local_data(
                    self.data_sharding, data
                )
                bounds = jax.make_array_from_process_local_data(
                    self._bounds_sharding, bounds
                )
            else:
                data = jax.device_put(data, self.data_sharding)
                bounds = jax.device_put(bounds, self._bounds_sharding)
        if self._bloom_step is not None:
            from pattern_matching.ops.bloom import BloomHits

            total, bits = self._bloom_step(self._bloom.words, data, bounds)
            if self._dvf_mesh is not None or self._dvf_pshard is not None:
                # the meshed device-verify stage walks the SAME sharded
                # arrays the probe scanned — keep the handles
                return BloomHits(
                    meta=total, bits=bits, data=data, bounds=bounds
                )
            return BloomHits(meta=total, bits=bits)
        if self._bloom is not None:
            if self._dvf is not None:
                # commit the batch to the device ONCE so the verify stage
                # walks the same arrays the probe scanned (no re-upload)
                import jax
                from pattern_matching.ops.bloom import BloomHits

                data = jax.device_put(data, self.device)
                bounds = jax.device_put(bounds, self.device)
                h = self._bloom.hits(data, bounds)
                return BloomHits(
                    meta=h.meta, bits=h.bits, data=data, bounds=bounds
                )
            return self._bloom.hits(data, bounds)
        if self._dense_step is not None:
            return self._dense_step(data, bounds)
        return scan_and_compact(
            self.dev,
            data,
            bounds,
            halo=batch.halo,
            max_results=self.max_results,
            sort=self.sort,
            chunk_len=self.chunk_len,
        )

    def decode(self, batch: HostBatch, comp) -> BatchMatches:
        """Pull compacted matches to host and expand match groups.

        Exactly two device-to-host transfers per batch (meta, then the
        packed tuple block only when matches exist) — per-field pulls are
        latency-bound on remote-attached devices.
        """
        from pattern_matching.ops.bloom import BloomHits

        if isinstance(comp, BloomHits):
            return self._decode_bloom(batch, comp)
        from pattern_matching.parallel.mesh import MeshDenseMatches

        if isinstance(comp, MeshDenseMatches):
            return self._decode_dense_mesh(batch, comp)
        meta = np.asarray(comp.meta)
        total, reported = int(meta[0]), int(meta[1])
        if reported:
            # fetch only a power-of-two bucket >= reported: transfer stays
            # proportional to matches while the slice-op shapes (and thus
            # compiles) stay bounded to log2(K) variants
            K = comp.packed.shape[1]
            bucket = 256
            while bucket < reported:
                bucket *= 2
            bucket = min(bucket, K)
            packed = np.asarray(comp.packed[:, :bucket])
            lane, pos, _state, gid, _rep = packed
        events = []
        for k in range(reported):
            ln = int(lane[k])
            g = int(gid[k])
            pids = self._groups[g]
            events.append(
                MatchEvent(
                    file_id=int(batch.file_ids[ln]),
                    end_offset=int(batch.base_off[ln]) + int(pos[k]),
                    pattern_indices=pids,
                    rep_index=pids[0],
                    lane=ln,
                    gid=g,
                )
            )
        if self.sort:
            # canonical order (MATCHING.md "--sort semantics"): same key
            # as the bloom engine's array sort, so the two engines'
            # sorted outputs are byte-identical. The device-side
            # (lane, pos) sort in the fused dispatch still helps: it
            # makes this a nearly-sorted pass.
            events.sort(key=lambda ev: (ev.file_id, ev.end_offset))
        return BatchMatches(
            events=events,
            total=total,
            reported=reported,
            overflowed=total > reported,
        )

    def _candidate_rows(self, comp) -> tuple[np.ndarray, np.ndarray]:
        """(rows, lanes) of candidate grams from the survivor bitmap,
        with lanes as indices into THIS HOST's batch.

        Multi-process meshes: the global bitmap is not fully addressable,
        so each host decodes only its own lane columns; global column ids
        (recovered from the shard's index) rebase by the host's first lane
        so they index the local batch the host fed — the host-local half
        of the data-parallel layout."""
        from pattern_matching.ops.bloom import unpack_hit_rows

        stride = self.bloom_table.cfg.stride
        bits = comp.bits
        if getattr(bits, "is_fully_addressable", True):
            return unpack_hit_rows(np.asarray(bits), stride)
        rows_parts: list[np.ndarray] = []
        lane_parts: list[np.ndarray] = []
        seen: set[int] = set()
        for sh in bits.addressable_shards:
            col0 = sh.index[1].start or 0
            if col0 in seen:  # replicated rows: decode each shard once
                continue
            seen.add(col0)
            r, l = unpack_hit_rows(np.asarray(sh.data), stride)
            rows_parts.append(r)
            lane_parts.append(l + col0)
        if not rows_parts:
            z = np.zeros(0, np.int64)
            return z, z
        lane0 = min(seen)  # this host's first global lane (its shards are
        # contiguous: jax device order groups devices by process)
        return (
            np.concatenate(rows_parts),
            np.concatenate(lane_parts) - lane0,
        )

    def _events_from_arrays(
        self, batch: HostBatch, ln_a, e_a, gid_a
    ) -> list[MatchEvent]:
        """Materialize MatchEvents from verified (lane, end, gid) arrays
        (shared by the host native-walker and device-verify paths).

        ``sort`` applies the CANONICAL order (see MATCHING.md "--sort
        semantics"): (file_id, absolute end_offset) — identical across
        engines and feeder interleavings, unique per event (one event per
        end position per file), so sorted outputs diff byte-identically
        between engines over any multi-batch stream."""
        file_ids = batch.file_ids
        base_off = batch.base_off
        halo = batch.halo
        if self.sort and len(ln_a):
            end_abs = base_off[ln_a] + e_a - halo
            order = np.lexsort((end_abs, file_ids[ln_a]))
            ln_a, e_a, gid_a = ln_a[order], e_a[order], gid_a[order]
        groups = self._groups
        events = []
        for ln, e, g in zip(ln_a.tolist(), e_a.tolist(), gid_a.tolist()):
            pids = groups[g]
            events.append(
                MatchEvent(
                    file_id=int(file_ids[ln]),
                    end_offset=int(base_off[ln]) + e - halo,
                    pattern_indices=pids,
                    rep_index=pids[0],
                    lane=ln,
                    gid=g,
                )
            )
        return events

    def _decode_dense_mesh(self, batch: HostBatch, comp) -> BatchMatches:
        """Host-local decode of the lane-sharded dense results
        (parallel.mesh.MeshDenseMatches): each addressable packed block
        holds one device's compacted tuples over its OWN lanes; local
        lane ids rebase by the device's global lane offset, then by this
        host's first lane — the same contiguous-per-process device-order
        assumption as every other mesh decode path."""
        cap = comp.packed.shape[2]
        C_local = self.max_chunks // self._mesh_ctx.num_devices
        per_meta: dict[int, np.ndarray] = {}
        for sh in comp.metas.addressable_shards:
            d = sh.index[0].start or 0
            per_meta[d] = np.asarray(sh.data)[0]
        g_total = g_rep = 0
        blocks: list[tuple[int, np.ndarray]] = []
        seen: set[int] = set()
        for sh in comp.packed.addressable_shards:
            d = sh.index[0].start or 0
            if d in seen:
                continue
            seen.add(d)
            m = per_meta[d]
            g_total, g_rep = int(m[0]), int(m[1])  # psum: same per row
            rep = min(int(m[3]), cap)
            if rep:
                blocks.append((d, np.asarray(sh.data)[0][:, :rep]))
        lane0 = min(seen) * C_local if seen else 0
        file_ids = batch.file_ids
        base_off = batch.base_off
        groups = self._groups
        events = []
        for d, blk in blocks:
            ln_a = blk[0].astype(np.int64) + d * C_local - lane0
            for k in range(blk.shape[1]):
                ln = int(ln_a[k])
                g = int(blk[3][k])
                pids = groups[g]
                events.append(
                    MatchEvent(
                        file_id=int(file_ids[ln]),
                        end_offset=int(base_off[ln]) + int(blk[1][k]),
                        pattern_indices=pids,
                        rep_index=pids[0],
                        lane=ln,
                        gid=g,
                    )
                )
        if self.sort:  # canonical order (MATCHING.md "--sort semantics")
            events.sort(key=lambda ev: (ev.file_id, ev.end_offset))
        return BatchMatches(
            events=events,  # this host's lane-shard-local set
            total=g_total,  # exact GLOBAL event count (psum, incl.
            reported=len(events),  # per-lane slot overflow)
            overflowed=g_total > g_rep,
            total_is_global=True,
        )

    def _merge_pshard_events(
        self, batch: HostBatch, sh_a, ln_a, e_a, st_a
    ) -> list[MatchEvent]:
        """Merge per-shard device event rows into global MatchEvents.

        A pattern lives in exactly one shard, so the union over shards of
        the per-shard co-terminating sets at one (lane, end) is the
        GLOBAL co-terminating pattern set at that end — the same event the
        single-table walk (and the reference kernel, ahomatch.cl:63-74)
        emits. Keyed on (lane, end); shard-local states translate
        shard group -> global pattern ids via the shard's id map."""
        v = self._dvf_pshard
        merged: dict[tuple[int, int], set] = {}
        for s, ln, e, st in zip(
            sh_a.tolist(), ln_a.tolist(), e_a.tolist(), st_a.tolist()
        ):
            g = int(v.shard_state_gid_host[s][st])
            merged.setdefault((ln, e), set()).update(
                v.shard_groups_global[s][g]
            )
        file_ids = batch.file_ids
        base_off = batch.base_off
        halo = batch.halo
        events = []
        for (ln, e), pidset in merged.items():
            pids = sorted(pidset)
            events.append(
                MatchEvent(
                    file_id=int(file_ids[ln]),
                    end_offset=int(base_off[ln]) + e - halo,
                    pattern_indices=pids,
                    rep_index=pids[0],
                    lane=ln,
                    gid=self._gid_of_pidset.get(tuple(pids), -1),
                )
            )
        if self.sort:  # canonical order (MATCHING.md "--sort semantics")
            events.sort(key=lambda ev: (ev.file_id, ev.end_offset))
        return events

    def _device_verify(self, comp, total: int):
        """Run the device verify stage; (meta, packed, gcounts) host arrays
        or None when this batch exceeds the device cap (host fallback)."""
        try:
            return self._dvf.verify(comp.data, comp.bounds, comp.bits, total)
        except RuntimeError as e:
            from pattern_matching.utils.debug import dprint

            dprint(1, "device verify fell back to host: %s", e)
            return None

    def _decode_bloom(self, batch: HostBatch, comp) -> BatchMatches:
        """Verify device candidates exactly (host verifier or the device
        verify stage, per ``verify_mode``).

        Two transfers max on either path: the popcount total (4 bytes),
        then the survivor bitmap (host verify) or the packed event block
        (device verify) only when total > 0 — there is no capacity cap.
        Event materialization is array-driven on the native-walker path:
        one verified (lane, end, state) row per event, group id via one
        state_gid gather (the per-event dict/set/sort grouping was the
        decode bottleneck on match-dense input)."""
        meta_h = np.asarray(comp.meta)
        total = int(meta_h[0])
        # meshed probes report [global_total, max_per_shard_total]; the
        # per-shard max is the capacity bound the mesh verifier buckets on
        total_max = int(meta_h[1]) if meta_h.shape[0] > 1 else total
        bl = self._bloom
        if (
            bl is not None
            and getattr(bl, "exact_meta", None) is not None
            and total > bl.k_ref
        ):
            # Refine-capacity overflow: the probe passed the UNREFINED
            # bitmap through (this batch is absorbed losslessly by the
            # host verify below). A refined total can never exceed k_ref
            # without overflow, so the check is exact. Grow the bucket so
            # a persistently match-dense stream stops paying full host
            # verify every batch (log-bounded recompiles; capped at
            # MAX_DEVICE_CAND — past that host verify IS the right tool).
            from pattern_matching.ops.verify_device import (
                MAX_DEVICE_CAND,
                next_cap,
            )

            if bl.k_ref < MAX_DEVICE_CAND:
                from pattern_matching.utils.debug import dprint

                bl.k_ref = int(min(MAX_DEVICE_CAND, next_cap(total)))
                dprint(
                    1,
                    "bloom refine overflow (%d candidates): k_ref -> %d",
                    total, bl.k_ref,
                )
        if total and self._dvf_pshard is not None and comp.data is not None:
            try:
                sh_a, ln_a, e_a, st_a, _gc = self._dvf_pshard.verify(
                    comp.data, comp.bounds, comp.bits, total_max
                )
            except RuntimeError as e:
                from pattern_matching.utils.debug import dprint

                dprint(1, "pshard device verify fell back to host: %s", e)
            else:
                events = self._merge_pshard_events(
                    batch, sh_a, ln_a, e_a, st_a
                )
                from pattern_matching.parallel.mesh import (
                    allreduce_host_counts,
                )

                n_glob = int(
                    allreduce_host_counts(
                        np.array([len(events)], np.int64)
                    )[0]
                )
                return BatchMatches(
                    events=events,  # this host's lane-shard-local set
                    total=n_glob,  # exact GLOBAL merged event count
                    reported=len(events),
                    overflowed=False,
                    total_is_global=True,
                )
        if total and self._dvf_mesh is not None and comp.data is not None:
            try:
                n_ev, ln_a, e_a, st_a, _gc = self._dvf_mesh.verify(
                    comp.data, comp.bounds, comp.bits, total_max
                )
            except RuntimeError as e:
                from pattern_matching.utils.debug import dprint

                dprint(1, "mesh device verify fell back to host: %s", e)
            else:
                gid_a = self.table.state_gid[st_a]
                events = self._events_from_arrays(batch, ln_a, e_a, gid_a)
                return BatchMatches(
                    events=events,
                    total=n_ev,  # exact GLOBAL count; events are this
                    reported=len(events),  # host's lane-shard-local set
                    overflowed=False,
                    total_is_global=True,
                )
        if total and self._dvf is not None and comp.data is not None:
            out = self._device_verify(comp, total)
            if out is not None:
                meta, packed, _gc = out
                ln_a, e_a, st_a = packed
                gid_a = self.table.state_gid[st_a]
                events = self._events_from_arrays(batch, ln_a, e_a, gid_a)
                return BatchMatches(
                    events=events,
                    total=int(meta[0]),
                    reported=len(events),
                    overflowed=False,
                )
        if total:
            rows, lanes = self._candidate_rows(comp)
        else:
            rows = lanes = np.zeros(0, np.int64)
        arr = self._verifier.verify_batch_arrays(
            batch.data, lanes, rows, batch.halo, batch.start_t, batch.end_t
        )
        events = []
        if arr is not None:
            ln_a, e_a, st_a = arr
            gid_a = self.table.state_gid[st_a]
            events = self._events_from_arrays(batch, ln_a, e_a, gid_a)
        else:  # no native dense walker: tuple fallback
            grouped: dict[tuple[int, int], set[int]] = {}
            for ln, e, pid in self._verifier.verify_batch(
                batch.data, lanes, rows, batch.halo,
                batch.start_t, batch.end_t,
            ):
                grouped.setdefault((ln, e), set()).add(pid)
            for ln, e in grouped.keys():
                pids = sorted(grouped[(ln, e)])
                events.append(
                    MatchEvent(
                        file_id=int(batch.file_ids[ln]),
                        end_offset=int(batch.base_off[ln]) + e - batch.halo,
                        pattern_indices=pids,
                        rep_index=pids[0],
                        lane=ln,
                        gid=self._gid_of_pidset.get(tuple(pids), -1),
                    )
                )
            if self.sort:  # canonical order, same as every other path
                events.sort(key=lambda ev: (ev.file_id, ev.end_offset))
        return BatchMatches(
            events=events,
            total=len(events),
            reported=len(events),
            overflowed=False,
        )

    def decode_counts(self, batch: HostBatch, comp) -> tuple[int, np.ndarray]:
        """(total_events, per-group counts [G]) WITHOUT materializing
        per-event objects — the vectorized count path for match-dense and
        psum workloads. Bloom: NumPy bincount over the native walker's
        verified rows; dense: the device-side per_group_counts reduction.

        With ``mesh=`` + ``verify='device'`` the counts come back already
        psum-reduced across the WHOLE mesh (all processes' lanes) — do
        NOT allreduce_host_counts them again. Every other path counts
        this host's lanes only (reduce across hosts yourself)."""
        from pattern_matching.ops.bloom import BloomHits

        G = self.table.num_groups
        if isinstance(comp, BloomHits):
            meta_h = np.asarray(comp.meta)
            total = int(meta_h[0])
            if not total:
                return 0, np.zeros(G, np.int64)
            if self._dvf_pshard is not None and comp.data is not None:
                total_max = (
                    int(meta_h[1]) if meta_h.shape[0] > 1 else total
                )
                try:
                    sh_a, ln_a, e_a, st_a, _gc = self._dvf_pshard.verify(
                        comp.data, comp.bounds, comp.bits, total_max
                    )
                except RuntimeError as e:
                    from pattern_matching.utils.debug import dprint

                    dprint(
                        1, "pshard device count fell back to host: %s", e
                    )
                else:
                    # merged (global-group) counts for this host's lanes,
                    # then allreduce — same global contract as the 1D
                    # mesh verifier's psum counts
                    from pattern_matching.parallel.mesh import (
                        allreduce_host_counts,
                    )

                    events = self._merge_pshard_events(
                        batch, sh_a, ln_a, e_a, st_a
                    )
                    loc = np.zeros(G + 1, np.int64)  # [counts..., total]
                    loc[G] = len(events)
                    for ev in events:
                        if ev.gid >= 0:
                            loc[ev.gid] += 1
                    red = allreduce_host_counts(loc).astype(np.int64)
                    return int(red[G]), red[:G]
            if self._dvf_mesh is not None and comp.data is not None:
                total_max = (
                    int(meta_h[1]) if meta_h.shape[0] > 1 else total
                )
                try:
                    n_ev, *_rest, gc = self._dvf_mesh.verify(
                        comp.data, comp.bounds, comp.bits, total_max
                    )
                    return n_ev, gc.astype(np.int64)
                except RuntimeError as e:
                    from pattern_matching.utils.debug import dprint

                    dprint(
                        1, "mesh device count fell back to host: %s", e
                    )
            if self._dvf is not None and comp.data is not None:
                out = self._device_verify(comp, total)
                if out is not None:
                    # gcounts accumulated on device from the full report
                    # stream: exact regardless of event-slot capacity
                    meta, _packed, gc = out
                    return int(meta[0]), gc.astype(np.int64)
            rows, lanes = self._candidate_rows(comp)
            arr = self._verifier.verify_batch_arrays(
                batch.data, lanes, rows, batch.halo,
                batch.start_t, batch.end_t,
            )
            if arr is None:
                bm = self._decode_bloom(batch, comp)
                return bm.total, self.event_group_counts(bm)
            ln_a, _e_a, st_a = arr
            gid_a = self.table.state_gid[st_a]
            return len(ln_a), np.bincount(gid_a, minlength=G).astype(
                np.int64
            )
        from pattern_matching.parallel.mesh import MeshDenseMatches

        if isinstance(comp, MeshDenseMatches):
            # in-scan gcounts psum'd across the WHOLE mesh on device —
            # already global, like the mesh device-verify count path
            m = np.asarray(comp.metas.addressable_shards[0].data)[0]
            return int(m[0]), np.asarray(comp.gcounts).astype(np.int64)
        # dense engine: the in-scan gcounts are exact even past slot
        # overflow (the slot-derived per_group_counts undercount there)
        if getattr(comp, "gcounts", None) is not None:
            return int(np.asarray(comp.meta)[0]), np.asarray(
                comp.gcounts
            ).astype(np.int64)
        return int(np.asarray(comp.meta)[0]), np.asarray(
            per_group_counts(self.dev, comp)
        ).astype(np.int64)

    def scan_and_decode(self, batch: HostBatch) -> BatchMatches:
        return self.decode(batch, self.scan(batch))

    def group_counts(self, comp: CompactMatches) -> np.ndarray:
        """Device-side per-group counts (dense engine); bloom sessions
        count host-verified events instead — use decode_counts or
        event_group_counts."""
        if self.dev is None:
            raise ValueError(
                "group_counts needs the dense engine; bloom sessions "
                "count via decode_counts/event_group_counts"
            )
        return np.asarray(per_group_counts(self.dev, comp))

    def event_group_counts(self, bm: BatchMatches) -> np.ndarray:
        """Per-group event counts [G] from decoded events (any engine).

        The bloom engine's count path for the psum workload (BASELINE
        config 5): exact verified events counted host-side. On
        multi-process meshes each host counts its local events; reduce
        with ``parallel.mesh.allreduce_host_counts``."""
        g = np.zeros(self.table.num_groups, np.int64)
        for ev in bm.events:
            if ev.gid >= 0:
                g[ev.gid] += 1
        return g

    # ----------------------------------------------------------- high level

    def scan_stream(
        self,
        fobj,
        file_id: int = 0,
        text_mode: bool = False,
        depth: int = 4,
    ) -> Iterator[BatchMatches]:
        """Scan one stream batch-by-batch (continuity handled via halos).

        ``depth`` batches are kept in flight before the first decode forces
        a device sync: rotating buffers dispatch batch k+depth while batch
        k's results come back (the reference's -w worker overlap, SURVEY
        2.5 pipeline parallelism; deeper than 2 matters on remote-attached
        devices where each decode costs a full roundtrip)."""
        from collections import deque

        depth = max(1, depth)
        bufs = [self.new_buffer()]  # grown lazily up to depth + 1: short
        cur = 0                     # scans keep the old 1-2 buffer footprint
        pending: deque[tuple[HostBatch, object]] = deque()
        stream = StreamState(file_id=file_id)
        while True:
            buf = bufs[cur]
            if text_mode:
                code, rd, _ = buf.add_lines(fobj, stream)
            else:
                code, rd = buf.add_stream(fobj, stream)
            # rd == 0 alone is NOT end-of-stream: a token buffer
            # (UshortBuffer) reads text in >= 4KB swaths and can fill
            # several batches from surplus parsed tokens without touching
            # the file again — only a non-full buffer that read nothing
            # has truly drained the stream (the feeder loops on the same
            # condition, feeder.py)
            eof = rd == 0 and code != -1
            if eof:
                # flush held parse state (token buffers may hold a partial
                # trailing number when the source is not seekable)
                buf.finalize_stream(stream)
            if buf.chunks and (code == -1 or eof):
                batch = buf.to_batch()
                pending.append((batch, self.scan(batch)))  # async dispatch
                if len(pending) > depth:
                    yield self.decode(*pending.popleft())
                if len(bufs) < depth + 1:
                    bufs.append(self.new_buffer())
                cur = (cur + 1) % len(bufs)
                bufs[cur].reset()
            if eof:
                break
        while pending:
            yield self.decode(*pending.popleft())

    def find(
        self, data: bytes, text_mode: bool = False
    ) -> list[tuple[int, int]]:
        """All (end_offset, pattern_index) events in ``data`` — the simplest
        library entry point; exact parity target vs the CPU oracle.

        For ushort-alphabet tables ``data`` is comma/whitespace-separated
        token TEXT (the flow-file format, AC_ushorts/README:27-31): it
        streams through UshortBuffer's incremental parser and offsets are
        in TOKEN units. Differentially fuzzed against the oracle on both
        alphabets (tools/fuzz_campaign.py).

        Fails LOUD if the dense engine's per-lane result slots overflow
        (raise ``max_results`` or use the capless bloom engine) — a
        partial result from the "give me all matches" API would be the
        silent loss the reference suffers from (ahomatch.cl:66) and this
        framework disavows. Streaming consumers that prefer to handle
        overflow themselves use :meth:`scan_stream` and the
        ``BatchMatches.overflowed`` flag."""
        out: list[tuple[int, int]] = []
        for bm in self.scan_stream(io.BytesIO(data), text_mode=text_mode):
            if bm.overflowed:
                raise RuntimeError(
                    f"result slots overflowed ({bm.total - bm.reported} "
                    f"events dropped in one batch): raise max_results "
                    f"(currently {self.max_results}) or use the bloom "
                    f"engine (no capacity cap)"
                )
            for ev in bm.events:
                out.extend(ev.expand())
        return sorted(out)


def session_for_patterns(
    patterns: Sequence[bytes], **kw
) -> MatchSession:
    from pattern_matching.core.dfa import compile_patterns

    return MatchSession(compile_patterns(patterns), **kw)
