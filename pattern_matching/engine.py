"""Engine selection: the best available device scan for a compiled table.

The two device scans:

- ``bloom``  — q-gram bloom filter probe + exact verify
- ``dense``  — signed-table DFA walk (exact on device); ``auto`` picks it

``best_scan_total_fn`` is the benchmark/bake-off hook: it returns a jittable
``f(data, start_t, end_t) -> int32 scalar`` whose value depends on every
lane's scan so the whole computation must execute, plus the halo the
caller must provide.
"""

from __future__ import annotations

from typing import Callable

import jax

from pattern_matching.core.dfa import DfaTable
from pattern_matching.ops.table import DeviceTable
from pattern_matching.utils.common import pad_halo


def best_scan_total_fn(
    table: DfaTable,
    max_chunks: int,
    chunk_len: int,
    engine: str = "auto",
    bloom_table=None,
) -> tuple[Callable, int]:
    """(scan_total, halo): scan_total(data, start_t, end_t) -> int32 total.

    ``bloom_table`` reuses a prebuilt filter — the chooser+insertion build
    is tens of seconds at 100k patterns and benchmarks that also report the
    config would otherwise pay it twice."""
    if engine == "auto":
        engine = "dense"
    halo = pad_halo(table.max_pat_len - 1, chunk_len)

    if engine == "bloom":
        from pattern_matching.ops.bloom import BloomFilterTable

        bft = (
            bloom_table
            if bloom_table is not None
            else BloomFilterTable.from_table(table)
        )
        dev = bft.put()

        def scan_total(data, start_t, end_t):
            return dev.probe_total(data, start_t, end_t, halo=halo)

        return scan_total, halo

    dev = DeviceTable.put(table)
    from pattern_matching.ops.match_xla import _scan_kernel

    def scan_total(data, start_t, end_t):
        data_tm = jax.lax.optimization_barrier(data.T)
        res = _scan_kernel(
            dev.table_flat,
            data_tm,
            start_t,
            end_t,
            alphabet_size=dev.alphabet_size,
            halo=halo,
            max_results=16,
        )
        return res.total + res.slot_pos[0, 0] * 0

    return scan_total, halo
