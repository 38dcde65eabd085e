"""Packet-metadata (ushort-alphabet) matching mode.

The AC_ushorts variant (SURVEY.md section 2.2): instead of byte strings, the
automaton matches *sequences of packet metadata* (e.g. payload lengths) for
encrypted-traffic inspection. Signatures: ``"40,32,287,...; 22; attack name"``
(AC_ushorts/README:14-24); inputs are per-flow files named by 5-tuple whose
content is a comma-separated int sequence (AC_ushorts/README:27-31).

The same generic DFA builder and scan engine are reused with
``alphabet_size=2048`` (AC_ushorts/iacsmx.h:43) and uint16 lanes; values >=
alphabet are clamped to ``alphabet-1`` (the reference indexes its table out
of bounds for such values — UB we do not reproduce).

The grep driver streams: flow text parses incrementally into uint16 token
lanes (``runtime.buffers.UshortBuffer``) fed through the threaded feeder in
rounds — the reference's ushort driver loops databuf rounds the same way
(AC_ushorts/databuf.c:154-190 + its ocl_aho_grep loop) — and ``-F`` follow
mode works on growing flow files/FIFOs (an extension: the reference's
ushort driver predates follow mode).
"""

from __future__ import annotations

import sys

import numpy as np

from pattern_matching.core.dfa import (
    ALPHABET_USHORT,
    AhoCorasick,
    DfaTable,
)
from pattern_matching.core.patterns import load_signature_file
from pattern_matching.runtime.buffers import UshortBuffer
from pattern_matching.runtime.feeder import Feeder
from pattern_matching.runtime.files import expand_paths
from pattern_matching.runtime.session import MatchSession
from pattern_matching.runtime.stats import RunStats
from pattern_matching.utils.common import cdiv, now_us


def compile_signatures(path: str, max_tokens: int = 16) -> DfaTable:
    parsed = load_signature_file(path, max_tokens=max_tokens)
    if not parsed:
        raise ValueError(f"no signatures in {path}")
    ac = AhoCorasick(ALPHABET_USHORT)
    for p in parsed:
        seq = tuple(min(v, ALPHABET_USHORT - 1) for v in p.data)
        ac.add_pattern(seq, iid=p.iid, label=p.label)
    return ac.compile()


def lanes_from_sequences(
    seqs: list[tuple[int, np.ndarray]],
    chunk_len: int,
    halo: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Tile per-flow token sequences into uint16 lanes with prefix halos.

    Returns (data [C, halo+B] uint16, start_t, end_t, file_ids, base_off).
    One-shot batch assembly for library/test use; the grep driver streams
    through UshortBuffer instead.
    """
    B, H = chunk_len, halo
    C = sum(max(1, cdiv(len(s), B)) for _, s in seqs)
    data = np.zeros((C, H + B), np.uint16)
    start_t = np.full(C, H, np.int32)
    end_t = np.full(C, H, np.int32)
    file_ids = np.full(C, -1, np.int32)
    base_off = np.zeros(C, np.int64)
    lane = 0
    for fid, s in seqs:
        off = 0
        while off < len(s) or (off == 0 and len(s) == 0):
            part = s[off : off + B]
            hist = s[max(0, off - H) : off]
            data[lane, H - len(hist) : H] = hist
            data[lane, H : H + len(part)] = part
            start_t[lane] = H - len(hist)
            end_t[lane] = H + len(part)
            file_ids[lane] = fid
            base_off[lane] = off
            lane += 1
            off += B
            if len(s) == 0:
                break
    return data, start_t, end_t, file_ids, base_off


def run_ushort_grep(args) -> int:
    """Drive the metadata-sequence grep (the AC_ushorts ocl_aho_grep path).

    Streaming rounds: flow files feed through UshortBuffer lanes via the
    threaded feeder (batched rounds, follow mode supported), scanned by a
    MatchSession on the chosen engine — ``bloom`` probes the alphabet-2048
    filter and verifies candidates with the symbol-width-generic native
    walker; ``dense`` walks the DFA on device (exact there)."""
    engine = getattr(args, "engine", "auto")
    if engine == "auto":
        engine = "dense"
    table = compile_signatures(args.pat_path, max_tokens=16)

    filenames = expand_paths(args.data_path)
    if not filenames:
        print("ERROR: Could not open input file(s) for reading.", file=sys.stderr)
        return 2

    # --mesh / --pat-shards apply to the metadata workload too.
    # pat_shards implies bloom.
    mesh = getattr(args, "mesh", None)
    if mesh is not None:
        mesh = "all" if mesh in ("all", "auto") else int(mesh)
    pat_shards = getattr(args, "pat_shards", 1)
    if pat_shards > 1:
        engine = "bloom"

    B = max(16, args.chunk_size // 2)  # tokens per lane
    sess = MatchSession(
        table,
        max_chunks=args.global_ws,
        chunk_len=B,
        max_results=args.max_results,
        sort=getattr(args, "sort", False),
        engine=engine,
        verify=getattr(args, "verify", "auto"),
        mesh=mesh,
        pat_shards=pat_shards,
    )
    import jax

    feeder = Feeder(
        filenames,
        n_workers=args.thread_no,
        # mesh lane alignment may round max_chunks up; multi-process
        # hosts feed only their own lane shard from their own files
        max_chunks=sess.local_chunks,
        chunk_len=B,
        halo=sess.halo,
        follow=getattr(args, "follow", False),
        buffer_factory=UshortBuffer,
        process_id=jax.process_index(),
        num_processes=jax.process_count(),
    )

    stats = RunStats(
        files=len(filenames),
        automaton_states=table.num_states,
        automaton_bytes=table.nbytes,
    )
    rd_bytes = 0  # raw text bytes vs converted ushort bytes (SURVEY 2.2:
    # the reference ushort driver tracks both, AC_ushorts/ocl_aho_grep.c:79-81)
    start = now_us()

    def consume(item, comp):
        nonlocal rd_bytes
        bm = sess.decode(item.batch, comp)
        stats.rounds += 1
        rd_bytes += item.bytes
        stats.bytes += item.batch.payload_bytes * 2  # uint16 tokens
        stats.matches_total += bm.total
        stats.matches_reported += sum(
            len(e.pattern_indices) for e in bm.events
        )
        if bm.overflowed:
            print(
                f"WARNING: result slots overflowed: "
                f"{bm.total - bm.reported} match(es) not reported this "
                f"round (raise -R)",
                file=sys.stderr,
            )
        if args.verbose:
            for ev in bm.events:
                fname = filenames[ev.file_id]
                for pidx in ev.pattern_indices:
                    pat = table.patterns[pidx]
                    off = ev.end_offset
                    print(
                        f"Pattern {pat.iid} ('{pat.label}') found in file "
                        f"'{fname}' at sequence offset {off - pat.n + 1} "
                        f"[end: {off}]"
                    )

    import signal
    from collections import deque

    # SIGINT: drain and flush, as the byte-mode CLI does
    # (ocl_aho_grep.c:25-31, 61-65)
    try:
        signal.signal(signal.SIGINT, lambda *_: feeder.stop())
    except ValueError:  # not the main thread (library embedding)
        pass

    feeder.start()
    # depth-1 pipeline in follow mode: a held batch's matches would wait
    # for the NEXT batch, which a quiet stream may never produce
    depth = 1 if getattr(args, "follow", False) else 2
    pending: deque = deque()
    for item in feeder:
        pending.append((item, sess.scan(item.batch)))
        if len(pending) >= depth:
            consume(*pending.popleft())
    while pending:
        consume(*pending.popleft())
    stats.wall_us = now_us() - start
    print(stats.render())
    if getattr(args, "json_stats", False):
        print(stats.to_json())
    return 0
