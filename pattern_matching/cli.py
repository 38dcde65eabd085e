"""``aho_grep`` — the grep-style CLI.

Mirrors the reference CLI surface (ocl_aho_grep.c:411-459, usage 150-204):

  -f file(s)      input: a directory, a single file, or comma-separated files
  -p file         pattern file (one per line; auto-detected "ID PATTERN"
                  categorical format)
  -B chunk_size   bytes per chunk lane
  -G global_ws    chunk lanes per batch (buffer = G * B bytes)
  -L local_ws     accepted for compatibility (kernel tiling is XLA's job)
  -D devpos       device position (index into jax.devices())
  -m max          truncate patterns to max bytes
  -w cpu_threads  feeder threads (round-robin over files, default 2)
  -R max          result slots per chunk (default 16)
  -v              verbose per-match lines ("Pattern <id> (...) found ...")
  -t              text mode (line-wise chunks)
  -x              printable-hex patterns
  -F              follow mode (keep scanning growing files/FIFOs)
  -M              accepted for compatibility (no mapped device buffers)
  -h              help

Extensions beyond the reference:
  --mesh N|all    data-parallel multi-chip scan (lanes sharded, table
                  replicated, totals psum-reduced)
  --engine        auto (dense) | bloom (q-gram filter + exact verify) |
                  dense (exact-on-device DFA walk)
  --ushort        packet-metadata mode (AC_ushorts variant): patterns are
                  metadata signatures ("seq; len; name"), inputs are
                  comma-separated ushort lines
  --sort          sort matches by offset before reporting (per batch)
  --sort-global   globally ordered verbose output for -w > 1 multi-file
                  runs (buffers the run's match lines; not for -F)
  --save-dfa/--load-dfa   compiled-automaton serialization (npz)
  --json-stats    machine-readable stats line in addition to the stats block
  --profile DIR   jax.profiler trace of the run
"""

from __future__ import annotations

import argparse
import signal
import sys


from pattern_matching.core.dfa import AhoCorasick, DfaTable, ALPHABET_USHORT
from pattern_matching.core.patterns import (
    load_pattern_file,
    load_signature_file,
)
from pattern_matching.runtime.feeder import Feeder
from pattern_matching.runtime.files import expand_paths
from pattern_matching.runtime.session import MatchSession
from pattern_matching.runtime.stats import RunStats
from pattern_matching.utils.common import enable_compile_cache, now_us


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="aho_grep",
        description="multi-pattern matcher (Aho-Corasick DFA scan)",
    )
    ap.add_argument("-f", dest="data_path", required=True, help="input file(s)/dir")
    ap.add_argument("-p", dest="pat_path", help="pattern file")
    ap.add_argument("-B", dest="chunk_size", type=int, default=4096)
    ap.add_argument("-G", dest="global_ws", type=int, default=2048)
    ap.add_argument("-L", dest="local_ws", type=int, default=0)  # compat no-op
    ap.add_argument("-D", dest="dev_pos", type=int, default=0)
    ap.add_argument("-m", dest="pat_size_limit", type=int, default=-1)
    ap.add_argument("-w", dest="thread_no", type=int, default=2)
    ap.add_argument("-R", dest="max_results", type=int, default=16)
    ap.add_argument("-v", dest="verbose", action="store_true")
    ap.add_argument("-t", dest="text_mode", action="store_true")
    ap.add_argument("-x", dest="hex_pat", action="store_true")
    ap.add_argument("-F", dest="follow", action="store_true")
    ap.add_argument("-M", dest="mapped", action="store_true")  # compat no-op
    ap.add_argument(
        "-i",
        dest="nocase",
        action="store_true",
        help="ASCII case-insensitive matching",
    )
    ap.add_argument("--ushort", action="store_true", help="packet-metadata mode")
    ap.add_argument("--sort", action="store_true")
    ap.add_argument(
        "--sort-global",
        dest="sort_global",
        action="store_true",
        help="buffer ALL verbose match lines and emit them in one global "
        "canonical (file, offset) order at end of run — batch/worker "
        "interleaving no longer shows (requires -v; memory grows with "
        "the total match count; incompatible with -F, which never ends). "
        "Multi-process runs order globally per host (hosts own disjoint "
        "files)",
    )
    ap.add_argument(
        "--mesh",
        default=None,
        metavar="N|all",
        help="data-parallel multi-chip scan: shard batch lanes over the "
        "first N devices (or all of them); the filter/DFA table "
        "replicates and survivor totals psum-reduce",
    )
    ap.add_argument(
        "--pat-shards",
        dest="pat_shards",
        type=int,
        default=1,
        metavar="S",
        help="partition the pattern set into S balanced shards, each "
        "with its own smaller bloom filter (the 300k+-pattern capacity "
        "axis); with --mesh the devices form a (pat, data) grid, "
        "otherwise the S probes run in one jit on one device. Bloom "
        "engine only",
    )
    ap.add_argument(
        "--coordinator",
        default=None,
        metavar="HOST:PORT",
        help="multi-host bring-up: jax.distributed coordinator address "
        "(run the same command on every host with its --process-id)",
    )
    ap.add_argument("--num-processes", type=int, default=1,
                    help="multi-host: total number of processes")
    ap.add_argument("--process-id", type=int, default=None,
                    help="multi-host: this process's id (0-based)")
    ap.add_argument(
        "--local-devices",
        default=None,
        metavar="IDS",
        help="multi-process: comma-separated ids of the cards of this "
        "host that this process uses (one process per card on a shared "
        "host); default all of the host's cards",
    )
    ap.add_argument(
        "--engine",
        choices=("auto", "bloom", "dense"),
        default="auto",
        help="scan engine: auto (default; dense, or bloom with "
        "--pat-shards), bloom (q-gram filter + exact verify), dense "
        "(signed-table DFA walk, exact on device)",
    )
    ap.add_argument(
        "--verify",
        choices=("auto", "host", "device"),
        default="auto",
        help="bloom engine exactness stage: host (native CPU window "
        "walker), device (candidate windows walk the dense table ON "
        "device — zero host CPU in the verify loop), auto (host)",
    )
    ap.add_argument("--save-dfa", dest="save_dfa")
    ap.add_argument("--load-dfa", dest="load_dfa")
    ap.add_argument(
        "--save-bloom", dest="save_bloom",
        help="dump the compiled bloom filter (npz) after building it",
    )
    ap.add_argument(
        "--load-bloom", dest="load_bloom",
        help="load a precompiled bloom filter instead of rebuilding "
        "(pair with --load-dfa for a build-free cold start)",
    )
    ap.add_argument("--json-stats", action="store_true")
    ap.add_argument("--profile", help="write a jax.profiler trace to this dir")
    return ap


MAX_PAT_SIZE = 4096  # reference utils.h:14


def check_args(args) -> None:
    """Argument validation (reference check_args, ocl_aho_grep.c:210-267).

    argparse covers presence/typing; the value-range rules are mirrored
    here with the reference's messages."""
    import os

    err = 0
    if args.pat_path and not os.path.exists(args.pat_path) and not args.load_dfa:
        print(f"ERROR: File '{args.pat_path}' does not exist", file=sys.stderr)
        err += 1
    if args.thread_no <= 0:
        print("ERROR: The thread number must be greater than 0", file=sys.stderr)
        err += 1
    if args.pat_size_limit != -1 and args.pat_size_limit <= 0:
        print("ERROR: The pattern size limit should be >= 1", file=sys.stderr)
        err += 1
    if args.pat_size_limit >= MAX_PAT_SIZE:
        print(
            f"ERROR: The pattern size limit should be <= {MAX_PAT_SIZE - 1}",
            file=sys.stderr,
        )
        err += 1
    if args.max_results <= 0:
        print("ERROR: The maximum result cells should be >= 1", file=sys.stderr)
        err += 1
    if args.chunk_size <= 0 or args.global_ws <= 0:
        print("ERROR: chunk size and global work size must be >= 1",
              file=sys.stderr)
        err += 1
    if getattr(args, "sort_global", False) and args.follow:
        print(
            "ERROR: --sort-global buffers the whole run's matches; a -F "
            "follow stream never ends (use --sort for per-batch order)",
            file=sys.stderr,
        )
        err += 1
    if err:
        sys.exit(2)


def align_parameters(args) -> None:
    """Round -B (and -L/-G, accepted for compatibility) to 16 with a
    warning (reference align_parameters, ocl_aho_grep.c:315-346)."""
    from pattern_matching.utils.common import roundup

    if args.local_ws % 16:
        fixed = roundup(args.local_ws, 16)
        print(
            f"WARNING: local work size '{args.local_ws}' is not 16B "
            f"aligned. Will use '{fixed}' instead",
            file=sys.stderr,
        )
        args.local_ws = fixed
    if args.global_ws % 16:
        fixed = roundup(args.global_ws, 16)
        print(
            f"WARNING: global work size {args.global_ws} is not 16B "
            f"aligned. Will use '{fixed}' instead.",
            file=sys.stderr,
        )
        args.global_ws = fixed
    if args.chunk_size % 16:
        fixed = roundup(args.chunk_size, 16)
        print(
            f"WARNING: max chunk size '{args.chunk_size}' is not 16B aligned. "
            f"Will use '{fixed}' instead.",
            file=sys.stderr,
        )
        args.chunk_size = fixed


def raise_nofile_limit() -> None:
    """Expand RLIMIT_NOFILE to the hard max (ocl_aho_grep.c:462-472)."""
    try:
        import resource

        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < hard:
            resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    except Exception:
        pass


def compile_table(args) -> DfaTable:
    if args.load_dfa:
        return DfaTable.load(args.load_dfa)
    if not args.pat_path:
        print("ERROR: No pattern file", file=sys.stderr)
        sys.exit(2)
    if args.ushort:
        parsed = load_signature_file(args.pat_path)
        ac = AhoCorasick(ALPHABET_USHORT)
    else:
        parsed = load_pattern_file(
            args.pat_path, hex_pat=args.hex_pat, pat_size_limit=args.pat_size_limit
        )
        ac = AhoCorasick(nocase=getattr(args, "nocase", False))
    if not parsed:
        print("ERROR: pattern file is empty", file=sys.stderr)
        sys.exit(2)
    for p in parsed:
        ac.add_pattern(p.data, iid=p.iid, label=p.label)
    table = ac.compile()
    if args.save_dfa:
        table.save(args.save_dfa)
    return table


def main(argv: list[str] | None = None) -> int:
    args = build_argparser().parse_args(argv)
    raise_nofile_limit()
    check_args(args)
    align_parameters(args)
    # stdout is the L5->L6 API (apps consume the verbose match lines,
    # SURVEY section 5 "stdout only"); when it is a pipe Python block-
    # buffers ~8 KB, so in -F follow mode a match line can sit invisible
    # to the consumer for unbounded time. Line-buffer it.
    try:
        sys.stdout.reconfigure(line_buffering=True)
    except (AttributeError, ValueError):  # non-standard streams
        pass
    enable_compile_cache()

    if args.num_processes > 1:
        # multi-host bring-up BEFORE any device use: all hosts join the
        # same jax.distributed job and see one global device set (the
        # capability the reference approximates with one process per
        # device, extended across hosts — SURVEY 2.5)
        if args.process_id is None:
            print("ERROR: --num-processes needs --process-id",
                  file=sys.stderr)
            sys.exit(2)
        from pattern_matching.parallel.mesh import init_distributed

        local = (
            [int(x) for x in args.local_devices.split(",")]
            if args.local_devices
            else None
        )
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id, local)
        if args.mesh is None:
            args.mesh = "all"  # a multi-host run IS a mesh run

    if args.ushort:
        from pattern_matching.ushort import run_ushort_grep

        return run_ushort_grep(args)

    import jax

    devs = jax.devices()
    if args.dev_pos >= len(devs):
        print(f"ERROR: device position {args.dev_pos} not available", file=sys.stderr)
        sys.exit(2)
    mesh = None
    if args.mesh is not None:
        mesh = "all" if args.mesh in ("all", "auto") else int(args.mesh)

    table = compile_table(args)

    filenames = expand_paths(args.data_path)
    if not filenames:
        print("ERROR: Could not open input file(s) for reading.", file=sys.stderr)
        sys.exit(2)

    bloom_table = None
    if args.load_bloom:
        import numpy as _np

        # sniff the dump flavor: sharded filters load as ShardedBloom
        with _np.load(args.load_bloom) as _z:
            is_sharded = "pshard_words" in _z
        if is_sharded:
            from pattern_matching.parallel.pshard import ShardedBloom

            bloom_table = ShardedBloom.load(args.load_bloom)
        else:
            from pattern_matching.ops.bloom import BloomFilterTable

            bloom_table = BloomFilterTable.load(args.load_bloom)

    sess = MatchSession(
        table,
        max_chunks=args.global_ws,
        chunk_len=args.chunk_size,
        max_results=args.max_results,
        sort=args.sort or args.sort_global,
        engine=args.engine,
        verify=args.verify,
        mesh=mesh,
        # -D selects the pos-th device (the reference's clinitctx device
        # walk, ocl_context.c:18-85); a mesh supersedes single-device pinning
        device=None if mesh is not None else args.dev_pos,
        bloom_table=bloom_table,
        pat_shards=args.pat_shards,
    )
    if args.save_bloom:
        if sess.engine == "bloom":
            sess.bloom_table.save(args.save_bloom)
        else:
            print(
                f"WARNING: --save-bloom ignored: the session resolved to "
                f"the '{sess.engine}' engine (no filter was built); pass "
                f"--engine bloom to force one",
                file=sys.stderr,
            )

    feeder = Feeder(
        filenames,
        n_workers=args.thread_no,
        # the session may round max_chunks up for mesh lane alignment;
        # multi-process: each host assembles only its own lane shard from
        # its own (disjoint, round-robin) file subset
        max_chunks=sess.local_chunks,
        chunk_len=args.chunk_size,
        halo=sess.halo,
        text_mode=args.text_mode,
        follow=args.follow,
        process_id=jax.process_index(),
        num_processes=jax.process_count(),
    )

    stats = RunStats(
        files=len(filenames),
        automaton_states=table.num_states,
        automaton_bytes=table.nbytes,
    )

    # SIGINT: drain and flush a final batch (ocl_aho_grep.c:25-31, 61-65)
    def _sigint(signum, frame):
        feeder.stop()

    signal.signal(signal.SIGINT, _sigint)

    from collections import deque

    from pattern_matching.runtime.tracing import device_trace

    def context_echo(batch, ev, pat_n: int) -> str:
        """The reference's match-context echo (ocl_aho_grep.c:289-303):
        text mode prints the matched line; binary mode a +-10-byte window
        around the occurrence, cut at the first newline."""
        row = batch.data[ev.lane]
        lo = int(batch.start_t[ev.lane])
        hi = int(batch.end_t[ev.lane])
        if args.text_mode:
            return bytes(row[batch.halo : hi]).decode(
                "latin-1", "replace"
            ).rstrip("\n")
        end_row = batch.halo + int(ev.end_offset - batch.base_off[ev.lane])
        w0 = max(lo, end_row - pat_n + 1 - 10)
        w1 = min(hi, end_row + 1 + 10)
        window = bytes(row[w0:w1])
        nl = window.find(b"\n")
        if nl != -1:
            window = window[:nl]
        return " ... " + window.decode("latin-1", "replace") + " ... "

    global_out: list = []  # --sort-global: (canonical key, rendered lines)
    mesh_total = 0  # totals that already count every process's lanes

    def consume(item, comp):
        nonlocal mesh_total
        bm = sess.decode(item.batch, comp)
        stats.rounds += 1
        stats.bytes += item.bytes
        stats.lines += item.lines
        if bm.total_is_global:
            mesh_total += bm.total
        else:
            stats.matches_total += bm.total
        # NOTE "Matches reported" counts expanded pattern ids (one per
        # pattern in a co-terminating group); the reference counts stored
        # result slots, which DROPS all but the group head (acsmx.c:645-651)
        stats.matches_reported += sum(len(e.pattern_indices) for e in bm.events)
        if bm.overflowed:
            print(
                f"WARNING: result slots overflowed: {bm.total - bm.reported} "
                f"match(es) not reported this round (raise -R)",
                file=sys.stderr,
            )
        if args.verbose:
            for ev in bm.events:
                fname = filenames[ev.file_id]
                for pidx in ev.pattern_indices:
                    pat = table.patterns[pidx]
                    start_off = ev.end_offset - pat.n + 1
                    rel = start_off - int(item.batch.base_off[ev.lane])
                    lines = (
                        f"Pattern {pat.iid} ('{pat.label}') found in file "
                        f"'{fname}' at offset {start_off} [relative: {rel}]"
                        f"\n{context_echo(item.batch, ev, pat.n)}"
                    )
                    if args.sort_global:
                        # consumer-side merge on the canonical key
                        # (MATCHING.md "--sort semantics"): batches arrive
                        # per-batch sorted; the run-end sort makes the
                        # order GLOBAL across worker/batch interleaving
                        global_out.append(
                            ((ev.file_id, ev.end_offset, pidx), lines)
                        )
                    else:
                        print(lines)

    start = now_us()
    with device_trace(args.profile):
        feeder.start()
        # depth-2 pipeline: the device scans batch k+1 while the host
        # decodes batch k (the role of the reference's -w worker overlap).
        # In follow mode the pipeline must be depth 1: a held batch's
        # matches would wait for the NEXT batch, which a quiet stream may
        # never produce — unbounded latency in the streaming mode.
        depth = 1 if args.follow else 2
        pending: deque = deque()
        if jax.process_count() > 1:
            # lockstep rounds: SPMD requires every process to dispatch the
            # same computation; hosts whose feeders ran dry contribute an
            # empty lane shard until ALL hosts are done (one tiny
            # allgather per round over DCN decides)
            from jax.experimental import multihost_utils

            import numpy as _np

            from pattern_matching.runtime.feeder import FeedItem

            it = iter(feeder)
            empty_batch = None
            while True:
                try:
                    item = next(it)
                except StopIteration:
                    item = None
                has = multihost_utils.process_allgather(
                    _np.asarray([0 if item is None else 1])
                )
                if not int(has.sum()):
                    break
                if item is None:
                    if empty_batch is None:
                        empty_batch = sess.new_buffer().to_batch()
                    item = FeedItem(batch=empty_batch, lines=0, bytes=0)
                pending.append((item, sess.scan(item.batch)))
                if len(pending) >= depth:
                    consume(*pending.popleft())
        else:
            for item in feeder:
                comp = sess.scan(item.batch)
                pending.append((item, comp))
                if len(pending) >= depth:
                    consume(*pending.popleft())
        while pending:
            consume(*pending.popleft())
    if args.sort_global:
        global_out.sort(key=lambda kv: kv[0])
        for _key, lines in global_out:
            print(lines)
    stats.wall_us = now_us() - start

    if jax.process_count() > 1:
        # global stats: per-host counters allreduce over DCN; each host
        # printed its own verbose lines (it is the only one that can — it
        # alone read those files), process 0 prints the global block
        import numpy as _np

        from pattern_matching.parallel.mesh import allreduce_host_counts

        tot = allreduce_host_counts(
            _np.asarray(
                [stats.matches_total, stats.matches_reported, stats.bytes,
                 stats.lines, stats.rounds],
                _np.int64,
            )
        )
        (stats.matches_total, stats.matches_reported, stats.bytes,
         stats.lines, stats.rounds) = (int(x) for x in tot)
        if jax.process_index() != 0:
            return 0
    stats.matches_total += mesh_total

    print(stats.render())
    if args.json_stats:
        print(stats.to_json())
    return 0


if __name__ == "__main__":
    sys.exit(main())
