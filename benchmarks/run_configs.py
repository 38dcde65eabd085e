"""The five BASELINE.json benchmark configs.

Each config prints one JSON line; ``--config N`` selects, default runs all.

1. generated word corpus vs CPU oracle, single chip, exact offsets
2. 2,000 hex signatures over 32 MiB random binary (replicated DFA)
3. 10,000 hex signatures over 64 MiB with compaction+sort pipeline
4. 15,000 hex signatures (truncated to 12 bytes, the reference's ``-m 12``)
   streaming multi-file grep through the feeder/CLI path
5. sentiment word patterns over generated text, lanes sharded across all
   devices with global per-group count reduction (psum workload)

The reference's corpus protocol (SURVEY.md section 6): 8 x 32MB urandom
binaries (test.sh) and ClamAV hex sets at 2k/10k/15k. Corpora here are
generated deterministically at the same scale points.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _hex_sigs(n: int, seed: int, length: int) -> list[bytes]:
    rng = np.random.RandomState(seed)
    return [bytes(rng.randint(0, 256, size=length).astype(np.uint8)) for _ in range(n)]


CLAMAV_DIR = "/root/reference/clamav_sample_sigs"


def _sig_set(n: int, seed: int, length: int, limit: int = -1):
    """The reference's REAL ClamAV signature sets when its checkout is
    present (heavy shared prefixes shift the bloom chooser's true-gram hit
    rate), else synthetic hex of the same scale.
    Returns (sigs, source_tag)."""
    path = os.path.join(CLAMAV_DIR, f"{n}.txt")
    if os.path.exists(path):
        from pattern_matching.core.patterns import load_pattern_file

        parsed = load_pattern_file(path, hex_pat=True, pat_size_limit=limit)
        return [p.data for p in parsed], "clamav"
    return _hex_sigs(n, seed, length if limit < 0 else limit), "synthetic"


def _random_file(path: str, mib: int, seed: int) -> str:
    if not os.path.exists(path) or os.path.getsize(path) != mib << 20:
        rng = np.random.RandomState(seed)
        with open(path, "wb") as f:
            for _ in range(mib):
                f.write(rng.bytes(1 << 20))
    return path


def emit(name: str, **kw) -> None:
    print(json.dumps({"config": name, **kw}), flush=True)


def config1() -> None:
    """Word corpus vs CPU oracle — exact (offset, pattern) parity."""
    from tests.fixtures import random_words_corpus
    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.core.oracle import match_python
    from pattern_matching.runtime.session import MatchSession

    patterns, corpus = random_words_corpus(seed=31, n_lines=2000)
    sess = MatchSession(compile_patterns(patterns), max_chunks=256, chunk_len=128)
    t0 = time.perf_counter()
    got = sess.find(corpus, text_mode=True)
    dt = time.perf_counter() - t0
    ok = got == sorted(match_python(patterns, corpus))
    emit("1_oracle_parity_words", parity=ok, events=len(got), wall_s=round(dt, 3))
    assert ok


def _scan_file_throughput(
    sigs: list[bytes], path: str, *, sort: bool, check_oracle: bool
) -> dict:
    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.runtime.session import MatchSession

    table = compile_patterns(sigs)
    sess = MatchSession(table, max_chunks=2048, chunk_len=4096, sort=sort)
    size = os.path.getsize(path)

    def one_pass():
        ev = []
        with open(path, "rb") as f:
            t0 = time.perf_counter()
            for bm in sess.scan_stream(f, file_id=0):
                ev.extend(
                    (e.end_offset, p)
                    for e in bm.events
                    for p in e.pattern_indices
                )
            return ev, time.perf_counter() - t0

    one_pass()  # compile + device warm-up pass
    events, dt = one_pass()
    out = {
        "bytes": size,
        "wall_s": round(dt, 3),
        "bytes_per_s": size / dt,
        "events": len(events),
        "states": table.num_states,
    }
    if check_oracle:
        try:
            from pattern_matching.core.oracle_native import NativeOracle

            o = NativeOracle(sigs)
            with open(path, "rb") as f:
                data = f.read()
            oracle_events = o.match_events(data)
            out["parity"] = sorted(events) == oracle_events
        except Exception as e:  # oracle unavailable: skip parity
            out["parity"] = f"skipped: {e}"
    return out


def _plant(path: str, sigs: list[bytes], n: int, chunk: int = 4096) -> None:
    """Plant signature occurrences (some straddling chunk boundaries) so the
    oracle-parity check is substantive."""
    rng = np.random.RandomState(123)
    with open(path, "r+b") as f:
        size = os.path.getsize(path)
        for k in range(n):
            sig = sigs[rng.randint(len(sigs))]
            if k % 4 == 0:  # straddle a chunk boundary
                pos = chunk * rng.randint(1, size // chunk - 1) - len(sig) // 2
            else:
                pos = rng.randint(0, size - len(sig))
            f.seek(pos)
            f.write(sig)


def config2(data_dir: str) -> None:
    sigs, src = _sig_set(2000, seed=2, length=16)
    path = _random_file(os.path.join(data_dir, "32MB.7p.bin"), 32, seed=7)
    _plant(path, sigs, 400)
    out = _scan_file_throughput(sigs, path, sort=False, check_oracle=True)
    emit("2_clamav2000_32MB", sigs=src, **out)
    assert out["parity"] is True
    assert out["events"] > 300  # plants found (a few may overwrite others)


def config3(data_dir: str) -> None:
    sigs, src = _sig_set(10_000, seed=3, length=16)
    p7 = _random_file(os.path.join(data_dir, "32MB.7q.bin"), 32, seed=7)
    p8 = _random_file(os.path.join(data_dir, "32MB.8.bin"), 32, seed=8)
    _plant(p7, sigs, 500)  # exact-parity evidence at the 10k scale point
    out7 = _scan_file_throughput(sigs, p7, sort=True, check_oracle=True)
    out8 = _scan_file_throughput(sigs, p8, sort=True, check_oracle=False)
    tot = out7["bytes"] + out8["bytes"]
    dt = out7["wall_s"] + out8["wall_s"]
    emit(
        "3_clamav10000_compact_sort",
        bytes=tot,
        wall_s=round(dt, 3),
        bytes_per_s=tot / dt,
        events=out7["events"] + out8["events"],
        states=out7["states"],
        parity=out7["parity"],
        sigs=src,
    )
    assert out7["parity"] is True


def config4(data_dir: str) -> None:
    """15k sigs truncated to 12B, multi-file streaming via the feeder."""
    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.runtime.feeder import Feeder
    from pattern_matching.runtime.session import MatchSession

    sigs, src = _sig_set(15_000, seed=4, length=12, limit=12)  # -m 12
    files = [
        _random_file(os.path.join(data_dir, f"32MB.{i}.bin"), 32, seed=i)
        for i in (1, 2, 3, 4)
    ]
    table = compile_patterns(sigs)
    sess = MatchSession(table, max_chunks=2048, chunk_len=4096)
    feeder = Feeder(
        files,
        n_workers=2,
        max_chunks=2048,
        chunk_len=4096,
        halo=sess.halo,
    )
    from collections import deque

    t0 = time.perf_counter()
    feeder.start()
    total_bytes = 0
    total_matches = 0
    rounds = 0
    pending: deque = deque()

    def consume(item, comp):
        nonlocal total_bytes, total_matches, rounds
        bm = sess.decode(item.batch, comp)
        total_bytes += item.bytes
        total_matches += bm.total
        rounds += 1

    for item in feeder:
        # depth-2 pipeline (decode of batch k overlaps scan of k+1), as
        # the CLI does — serial scan_and_decode pays a full roundtrip
        # per round on remote-attached devices
        pending.append((item, sess.scan(item.batch)))
        if len(pending) >= 2:
            consume(*pending.popleft())
    while pending:
        consume(*pending.popleft())
    dt = time.perf_counter() - t0
    emit(
        "4_clamav15000_streaming",
        bytes=total_bytes,
        wall_s=round(dt, 3),
        bytes_per_s=total_bytes / dt,
        matches=total_matches,
        rounds=rounds,
        states=table.num_states,
        sigs=src,
    )


def config6(data_dir: str) -> None:
    """Data-path-only baseline: feeder + batch assembly WITHOUT the device
    scan — the reference's _EMPTY no-op kernel role
    (AC_ushorts/ocl_worker.c:36-42): isolates host feed/staging overhead
    from matching."""
    from pattern_matching.runtime.feeder import Feeder

    files = [
        _random_file(os.path.join(data_dir, f"32MB.{i}.bin"), 32, seed=i)
        for i in (1, 2)
    ]
    feeder = Feeder(
        files, n_workers=2, max_chunks=2048, chunk_len=4096, halo=16
    )
    t0 = time.perf_counter()
    feeder.start()
    total_bytes = 0
    rounds = 0
    for item in feeder:
        total_bytes += item.bytes  # batches assembled, never dispatched
        rounds += 1
    dt = time.perf_counter() - t0
    emit(
        "6_datapath_only_empty_kernel",
        bytes=total_bytes,
        wall_s=round(dt, 3),
        bytes_per_s=total_bytes / dt,
        rounds=rounds,
    )

    # ushort arm: flow-text -> token ingest without the device scan (the
    # token path's _EMPTY baseline; the byte arm above cannot see the
    # parse cost)
    from pattern_matching.runtime.buffers import UshortBuffer

    flow = os.path.join(data_dir, "flow_tokens.txt")
    if not os.path.exists(flow) or os.path.getsize(flow) < 32 << 20:
        rng = np.random.RandomState(5)
        with open(flow, "w") as f:
            while f.tell() < (32 << 20):
                f.write(
                    ",".join(map(str, rng.randint(0, 1500, size=65536)))
                    + ","
                )
    feeder = Feeder(
        [flow], n_workers=1, max_chunks=2048, chunk_len=2048, halo=16,
        buffer_factory=UshortBuffer,
    )
    t0 = time.perf_counter()
    feeder.start()
    raw_bytes = 0
    tokens = 0
    for item in feeder:
        raw_bytes += item.bytes
        tokens += item.batch.payload_bytes // 2
    dt = time.perf_counter() - t0
    emit(
        "6u_ushort_datapath_only",
        text_bytes=raw_bytes,
        tokens=tokens,
        wall_s=round(dt, 3),
        text_bytes_per_s=raw_bytes / dt,
        tokens_per_s=tokens / dt,
    )


def config5() -> None:
    """Sentiment psum workload: lanes sharded across all devices.

    Runs THREE arms through the mesh, all required to agree exactly:
    the dense sharded step's on-device psum group counts; the flagship
    bloom engine via MatchSession(mesh=) with host-verified event counts
    (allreduced across processes); and the bloom probe + DEVICE verify +
    psum count step (make_sharded_bloom_count_step) with zero host CPU in
    the verify loop."""
    import io

    import jax

    from tests.fixtures import random_words_corpus
    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.ops.table import DeviceTable
    from pattern_matching.parallel.mesh import (
        MeshContext,
        allreduce_host_counts,
        make_mesh,
        make_sharded_bloom_count_step,
        make_sharded_scan_step,
    )
    from pattern_matching.runtime.buffers import DataBuffer, StreamState
    from pattern_matching.runtime.session import MatchSession

    words, corpus = random_words_corpus(seed=55, n_lines=5000, n_patterns=64)
    patterns = [b" " + w + b" " for w in words]
    table = compile_patterns(patterns)
    ctx = MeshContext(make_mesh())
    dev = DeviceTable.put(table, ctx.replicated)
    halo = table.max_pat_len - 1
    n_dev = ctx.num_devices
    # size lanes to hold the WHOLE corpus in one sharded batch (a lane
    # count below corpus/chunk_len would silently truncate the dense arm
    # while the bloom session streams everything — caught on the 1-chip
    # run), rounded to the mesh's 128-per-shard alignment
    from pattern_matching.utils.common import cdiv, roundup

    C = roundup(cdiv(len(corpus), 256) + 1, 128 * n_dev)
    buf = DataBuffer(C, 256, halo)
    buf.add_stream(io.BytesIO(corpus), StreamState(file_id=0))
    batch = buf.to_batch()
    step = make_sharded_scan_step(
        ctx, dev, halo=halo, max_results=16, num_groups=table.num_groups
    )
    args = (
        dev.table_flat,
        dev.state_gid,
        jax.device_put(batch.data, ctx.lane_sharded),
        batch.start_t,
        batch.end_t,
    )
    out = step(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = step(*args)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    gcounts = np.asarray(out[3])

    # the flagship engine on the same mesh via the product path
    sess = MatchSession(table, max_chunks=C, chunk_len=256,
                        engine="bloom", mesh=ctx)
    bcounts = np.zeros(table.num_groups, np.int64)
    t1 = time.perf_counter()
    for bm in sess.scan_stream(io.BytesIO(corpus)):
        bcounts += sess.event_group_counts(bm)
    bloom_dt = time.perf_counter() - t1
    bcounts = allreduce_host_counts(bcounts)
    agree = bool(np.array_equal(bcounts, gcounts.astype(np.int64)))

    # arm 3: bloom probe + DEVICE verify + psum — no host CPU in the loop
    cstep = make_sharded_bloom_count_step(
        ctx, sess._bloom, table, halo=sess.halo,
        gram_keys=sess.bloom_table.gram_keys,
    )
    buf2 = sess.new_buffer()
    buf2.add_stream(io.BytesIO(corpus), StreamState(file_id=0))
    b2 = buf2.to_batch()
    cargs = (
        sess._bloom.words,
        jax.device_put(
            np.ascontiguousarray(table.goto_signed).reshape(-1),
            ctx.replicated,
        ),
        jax.device_put(table.state_gid.astype(np.int32), ctx.replicated),
        jax.device_put(b2.data, ctx.lane_sharded),
        jax.device_put(
            np.stack([b2.start_t, b2.end_t]), ctx.lane_sharded2d
        ),
    )
    out2 = cstep(*cargs)
    jax.block_until_ready(out2)
    t2 = time.perf_counter()
    out2 = cstep(*cargs)
    jax.block_until_ready(out2)
    dev_verify_dt = time.perf_counter() - t2
    dcounts, n_ev, flags, _needs = (np.asarray(x) for x in out2)
    assert int(flags) == 0, "per-shard candidate capacity overflowed"
    dev_agree = bool(np.array_equal(dcounts.astype(np.int64), bcounts))

    emit(
        "5_sentiment_psum_sharded",
        devices=n_dev,
        bytes=len(corpus),
        wall_s=round(dt, 4),
        bytes_per_s=len(corpus) / dt,
        group_events=int(gcounts.sum()),
        bloom_engine_agrees=agree,
        bloom_wall_s=round(bloom_dt, 4),
        device_verify_agrees=dev_agree,
        device_verify_wall_s=round(dev_verify_dt, 4),
    )
    assert agree and dev_agree


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=0,
                    help="1-6, 0=all (6 = data-path-only _EMPTY baseline)")
    ap.add_argument("--data-dir", default="/tmp/tpm_bench_data")
    args = ap.parse_args()
    os.makedirs(args.data_dir, exist_ok=True)
    todo = [args.config] if args.config else [1, 2, 3, 4, 5, 6]
    runners = {
        1: config1,
        2: lambda: config2(args.data_dir),
        3: lambda: config3(args.data_dir),
        4: lambda: config4(args.data_dir),
        5: config5,
        6: lambda: config6(args.data_dir),
    }
    for c in todo:
        runners[c]()


if __name__ == "__main__":
    main()
