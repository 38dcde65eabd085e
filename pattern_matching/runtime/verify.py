"""Host verification stage for the bloom filter engine.

Expands device candidate grams (lane, row) into merged windows, scans each
window with an exact Aho-Corasick oracle (the native C++ one when buildable,
``core/oracle_native``; pure-Python otherwise), and emits exact
``(end_row, pattern_index_set)`` events. False positives from the bloom die
here; window geometry guarantees no true match is missed (ops/bloom.py
module docstring, coverage note).

This stage plays the role of the reference's host-side result walk
(``databuf_process_results``, databuf.c:747-782) — but where the reference
trusts the device kernel's exact events, the bloom engine's device pass is a
filter and THIS is the exactness boundary.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _fold_case(arr: np.ndarray) -> np.ndarray:
    out = arr.copy()
    mask = (out >= 65) & (out <= 90)
    out[mask] += 32
    return out


class Verifier:
    """Exact window verifier over a fixed pattern set."""

    def __init__(
        self,
        patterns: Sequence[Sequence[int]],
        alphabet_size: int = 256,
        q: int = 1,
        max_pat_len: int = 1,
        fold_case: bool = False,
        dense_table=None,  # DfaTable: enables the fast dense window walker
        threads: int | None = None,  # verify threads for match-heavy
        # batches; None sizes to the host (cpu_count - 1, leaving the
        # feeder a core): a fixed count underuses big hosts and is pure
        # overhead on a 1-core host
    ):
        import os as _os

        self.q = q
        self.lmax = max_pat_len
        self.fold_case = fold_case
        if threads is None:
            threads = max(1, (_os.cpu_count() or 2) - 1)
        self.threads = max(1, threads)
        self._dense = None
        self._oracle = None
        if dense_table is not None:
            # binding the walker to an int32 table is a zero-copy VIEW of
            # the compiler's own array, so table size costs nothing here
            # (a size guard here would disable the fast walker exactly
            # when pattern sets get big; only small int16 tables pay a
            # widening copy)
            try:
                from pattern_matching.core import oracle_native

                oracle_native._lib()  # raises if g++/so unavailable
                self._dense = (
                    np.ascontiguousarray(
                        dense_table.goto_signed, np.int32
                    ).reshape(-1),
                    dense_table.alphabet_size,
                    dense_table.state_gid,
                    dense_table.groups_as_lists(),
                )
            except Exception as e:
                from pattern_matching.utils.debug import dprint

                dprint(
                    1,
                    "native dense walker unavailable (%s): the sparse "
                    "oracle verifies instead (slower on match-dense "
                    "input)", e,
                )
                self._dense = None
        try:
            from pattern_matching.core.oracle_native import NativeOracle

            self._oracle = NativeOracle(patterns, alphabet=alphabet_size)
        except Exception:
            from pattern_matching.core.oracle import PyAhoCorasick

            self._py = PyAhoCorasick(patterns)

    def _scan_window(self, window: np.ndarray) -> list[tuple[int, int]]:
        if self.fold_case:
            window = _fold_case(window)
        if self._oracle is not None:
            # uint8 windows take the fast byte path; wider symbols
            # (ushort alphabet) must stay ndarrays — bytes() would split
            # each 2-byte symbol into two byte symbols and match nothing
            payload = (
                bytes(window) if window.dtype == np.uint8 else window
            )
            self._oracle.reset()
            off, pid, total = self._oracle.match(payload)
            if total > len(off):  # enormous window: re-run with room
                self._oracle.reset()
                off, pid, total = self._oracle.match(payload, cap=int(total))
            return list(zip(off.tolist(), pid.tolist()))
        events, _ = self._py.match(window.tolist())
        return events

    def windows_for(
        self, rows: Sequence[int], start_row: int, end_row: int
    ) -> list[tuple[int, int]]:
        """Merge candidate gram rows into disjoint verify windows.

        A match containing the gram at row r spans at most
        [r - (lmax - q), r + lmax); overlapping windows merge, so every
        match end falls in exactly one window (no duplicate reports).
        Windows never reach below ``start_row``: rows before it are
        zero-fill, not stream content (a pattern must not match "into" the
        missing history — the bloom analogue of the dense engine's start_t
        masking)."""
        pad_l = self.lmax - self.q
        out: list[tuple[int, int]] = []
        for r in sorted(set(int(x) for x in rows)):
            w0 = max(start_row, r - pad_l)
            w1 = min(end_row, r + self.lmax)
            if w1 <= w0:
                continue
            if out and w0 <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], w1))
            else:
                out.append((w0, w1))
        return out

    def verify_lane(
        self,
        lane_data: np.ndarray,  # [T] symbols (halo prefix included)
        rows: Sequence[int],
        halo: int,  # first row of this lane's own span
        start_row: int,  # first VALID row (>= 0; > 0 when history short)
        end_row: int,  # one past the last valid row
    ) -> list[tuple[int, int]]:
        """Exact (end_row, pattern_index) events attributed to this lane."""
        events: list[tuple[int, int]] = []
        for w0, w1 in self.windows_for(rows, start_row, end_row):
            for e_rel, pid in self._scan_window(lane_data[w0:w1]):
                e = w0 + int(e_rel)
                if halo <= e < end_row:
                    events.append((e, int(pid)))
        return events

    def merged_windows(
        self,
        cand_lanes: np.ndarray,  # [N] candidate gram lanes
        cand_rows: np.ndarray,  # [N] candidate gram start rows
        start_t: np.ndarray,  # [C]
        end_t: np.ndarray,  # [C]
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized per-lane interval merge of candidate verify windows.

        Same geometry as :meth:`windows_for`, but O(N log N) NumPy instead
        of a per-candidate Python loop — the decode path's host cost on
        match-heavy batches. Returns (lanes, w0s, w1s) of disjoint windows.
        """
        if len(cand_rows) == 0:
            empty = np.zeros(0, np.int64)
            return empty.astype(np.int32), empty, empty
        pad_l = self.lmax - self.q
        lanes = np.asarray(cand_lanes, np.int64)
        rows = np.asarray(cand_rows, np.int64)
        lo = np.asarray(start_t, np.int64)[lanes]
        hi = np.asarray(end_t, np.int64)[lanes]
        w0 = np.maximum(lo, rows - pad_l)
        w1 = np.minimum(hi, rows + self.lmax)
        keep = w1 > w0
        lanes, w0, w1 = lanes[keep], w0[keep], w1[keep]
        if len(w0) == 0:
            empty = np.zeros(0, np.int64)
            return empty.astype(np.int32), empty, empty
        # linearize lanes so intervals of different lanes can never touch,
        # then one global interval merge
        span = int(w1.max()) + 1
        k0 = lanes * span + w0
        k1 = lanes * span + w1
        order = np.argsort(k0, kind="stable")
        k0, k1 = k0[order], k1[order]
        cummax = np.maximum.accumulate(k1)
        new_grp = np.empty(len(k0), bool)
        new_grp[0] = True
        new_grp[1:] = k0[1:] > cummax[:-1]
        starts_idx = np.flatnonzero(new_grp)
        m_k0 = k0[starts_idx]
        m_k1 = np.maximum.reduceat(k1, starts_idx)
        # cummax guarantees groups are disjoint; recover (lane, w0, w1)
        m_lane = (m_k0 // span).astype(np.int32)
        return m_lane, m_k0 % span, m_k1 - m_lane.astype(np.int64) * span

    def verify_batch_arrays(
        self,
        data: np.ndarray,
        cand_lanes: np.ndarray,
        cand_rows: np.ndarray,
        halo: int,
        start_t: np.ndarray,
        end_t: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
        """(lanes i32[n], end_rows i64[n], states i32[n]) — the dense
        walker's raw output, one entry per match EVENT (the state resolves
        to the full co-terminating group via state_gid; merged windows are
        disjoint, so events are unique). None when the native dense walker
        is unavailable — fall back to :meth:`verify_batch`.

        This is the match-dense fast path: counting/grouping can stay in
        NumPy instead of materializing per-event Python tuples (measured
        decode-bound on match-saturated input)."""
        if self._dense is None or data.dtype not in (np.uint8, np.uint16):
            return None
        m_lane, m_w0, m_w1 = self.merged_windows(
            cand_lanes, cand_rows, start_t, end_t
        )
        if len(m_lane) == 0:
            return (
                np.zeros(0, np.int32),
                np.zeros(0, np.int64),
                np.zeros(0, np.int32),
            )
        return self._dense_windows(
            data, m_lane, m_w0, m_w1, halo, end_t
        )

    def _dense_windows(self, data, m_lane, m_w0, m_w1, halo, end_t):
        """Run the native dense window walker (threaded when large)."""
        from pattern_matching.core.oracle_native import (
            dense_match_windows,
        )

        table_flat, alphabet, _state_gid, _groups = self._dense
        la = np.ascontiguousarray(m_lane, np.int32)
        a0 = np.ascontiguousarray(m_w0, np.int64)
        a1 = np.ascontiguousarray(m_w1, np.int64)
        lo = np.full(len(la), halo, np.int64)
        hi = np.asarray(end_t, np.int64)[la]

        def run(sl):
            return dense_match_windows(
                table_flat, alphabet, data,
                la[sl], a0[sl], a1[sl], lo[sl], hi[sl],
            )

        nt = self.threads if len(la) >= 8192 else 1
        if nt > 1:
            # the ctypes call releases the GIL: window shards verify in
            # parallel on match-heavy batches
            from concurrent.futures import ThreadPoolExecutor

            bounds_idx = np.linspace(0, len(la), nt + 1, dtype=int)
            with ThreadPoolExecutor(nt) as pool:
                parts = list(
                    pool.map(
                        run,
                        [
                            slice(bounds_idx[i], bounds_idx[i + 1])
                            for i in range(nt)
                        ],
                    )
                )
            return (
                np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]),
                np.concatenate([p[2] for p in parts]),
            )
        return run(slice(None))

    def verify_batch(
        self,
        data: np.ndarray,  # [C, T] uint8 lane-major batch
        cand_lanes: np.ndarray,  # [N] candidate gram lanes
        cand_rows: np.ndarray,  # [N] candidate gram start rows
        halo: int,
        start_t: np.ndarray,  # [C]
        end_t: np.ndarray,  # [C]
    ) -> list[tuple[int, int, int]]:
        """All exact (lane, end_row, pattern_index) events for one batch.

        Merges candidate windows (vectorized), then verifies them in ONE
        native call — the per-window Python loop is the fallback when the
        C++ oracle could not be built."""
        m_lane, m_w0, m_w1 = self.merged_windows(
            cand_lanes, cand_rows, start_t, end_t
        )
        lanes = m_lane.tolist()
        w0s = m_w0.tolist()
        w1s = m_w1.tolist()
        khis = np.asarray(end_t, np.int64)[m_lane].tolist()
        if not lanes:
            return []
        if self._dense is not None and data.dtype in (
            np.uint8,
            np.uint16,
        ):
            _, _, state_gid, groups = self._dense
            out_lane, out_end, out_state = self._dense_windows(
                data, m_lane, m_w0, m_w1, halo, end_t
            )
            events: list[tuple[int, int, int]] = []
            for ln, e, st in zip(
                out_lane.tolist(), out_end.tolist(), out_state.tolist()
            ):
                for pid in groups[int(state_gid[st])]:
                    events.append((ln, e, pid))
            return events
        if self._oracle is not None and data.dtype == np.uint8:
            xlat = None
            if self.fold_case:
                xlat = np.arange(256, dtype=np.uint8)
                xlat[65:91] += 32
            out_lane, out_end, out_pid = self._oracle.match_windows(
                data,
                np.asarray(lanes, np.int32),
                np.asarray(w0s, np.int64),
                np.asarray(w1s, np.int64),
                np.full(len(lanes), halo, np.int64),
                np.asarray(khis, np.int64),
                xlat=xlat,
            )
            return list(
                zip(out_lane.tolist(), out_end.tolist(), out_pid.tolist())
            )
        events: list[tuple[int, int, int]] = []
        for ln, w0, w1, khi in zip(lanes, w0s, w1s, khis):
            for e_rel, pid in self._scan_window(data[ln, w0:w1]):
                e = w0 + int(e_rel)
                if halo <= e < khi:
                    events.append((ln, e, int(pid)))
        return events
