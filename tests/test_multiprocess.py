"""True multi-PROCESS distributed test: 2 processes x 2 CPU devices run the
sharded bloom step over a 4-device global mesh via jax.distributed — the
DCN-path analogue the reference never had (its only multi-device story is
independent pthreads, SURVEY.md section 2.5). Validates that the engine's
mesh program works when devices span processes, not just within one."""

import os
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent(
    """
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    sys.path.insert(0, os.getcwd())
    import jax
    jax.config.update("jax_platforms", "cpu")
    pid = int(sys.argv[1])
    port = sys.argv[2]
    jax.distributed.initialize(
        f"localhost:{port}", num_processes=2, process_id=pid
    )
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.ops.bloom import BloomFilterTable
    from pattern_matching.parallel.mesh import (
        MeshContext, make_mesh, make_sharded_bloom_step,
    )

    rng = np.random.RandomState(3)
    pats = [bytes(rng.randint(0, 256, size=8).astype(np.uint8))
            for _ in range(16)]
    table = compile_patterns(pats)
    bft = BloomFilterTable.from_table(table)

    n_global = jax.device_count()
    assert n_global == 4, n_global
    lanes = 128 * n_global
    T = 256
    data = rng.randint(0, 256, size=(lanes, T)).astype(np.uint8)
    data[5, 100:108] = np.frombuffer(pats[0], np.uint8)  # plant
    bounds = np.stack(
        [np.zeros(lanes, np.int32), np.full(lanes, T, np.int32)]
    )

    ctx = MeshContext(make_mesh(jax.devices()))
    bloom = bft.put(ctx.replicated)
    step = make_sharded_bloom_step(ctx, bloom)

    def shard_global(arr, spec):
        sharding = NamedSharding(ctx.mesh, spec)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx]
        )

    total, bits = step(
        bloom.words,
        shard_global(data, P("data")),
        shard_global(bounds, P(None, "data")),
    )
    jax.block_until_ready((total, bits))
    t = int(np.asarray(jax.device_get(total))[0])
    assert t >= 1, t  # the planted gram survives on every process's view

    # ---- the PRODUCT path across processes: the CLI with DISJOINT file
    # ownership (were every host to read the whole corpus, input
    # bandwidth could not scale with hosts).
    # Each host's feeder round-robins its own file subset into its own
    # lane shard; scan assembles the global array from process-local
    # shards; each host decodes + prints only ITS lanes; stats allreduce.
    import io
    import re
    from contextlib import redirect_stdout

    from pattern_matching.core.oracle import match_python
    from pattern_matching.cli import main

    workdir = sys.argv[3]
    rng3 = np.random.RandomState(99)
    n_files = 4
    expect = {}  # (file, start_offset, iid) set per file
    patfile = os.path.join(workdir, "pats.txt")
    if pid == 0:
        with open(patfile + ".tmp", "wb") as f:
            for p in pats:
                f.write(p.hex().encode() + b"\\n")
        os.rename(patfile + ".tmp", patfile)
        for i in range(n_files):
            payload = bytearray(
                rng3.randint(0, 256, size=40000).astype(np.uint8)
            )
            for pos in (50 + i, 9000 + 7 * i, 30000 + 11 * i):
                payload[pos : pos + 8] = pats[(pos + i) % 16]
            with open(os.path.join(workdir, f"in{i}.bin.tmp"), "wb") as f:
                f.write(bytes(payload))
            os.rename(os.path.join(workdir, f"in{i}.bin.tmp"),
                      os.path.join(workdir, f"in{i}.bin"))
    else:
        import time
        while not all(
            os.path.exists(os.path.join(workdir, f"in{i}.bin"))
            for i in range(n_files)
        ) or not os.path.exists(patfile):
            time.sleep(0.1)
    files = ",".join(
        os.path.join(workdir, f"in{i}.bin") for i in range(n_files)
    )
    # oracle expectation over ALL files (the union across hosts)
    want = set()
    for i in range(n_files):
        with open(os.path.join(workdir, f"in{i}.bin"), "rb") as f:
            data = f.read()
        for off, pidx in match_python(pats, data):
            want.add((i, off - len(pats[pidx]) + 1, pidx))

    def cli_run(engine):
        out = io.StringIO()
        with redirect_stdout(out):
            rc = main([
                "-f", files, "-p", patfile, "-x", "-v",
                "-B", "64", "-G", "512", "-w", "1",
                "--engine", engine,
                "--num-processes", "2", "--process-id", str(pid),
            ])
        assert rc == 0
        return out.getvalue()

    def stats_matches(text):
        m = re.search(r"Matches:\\s+(\\d+)", text)
        return int(m.group(1)) if m else None

    text = cli_run("bloom")
    got = set()
    for m in re.finditer(
        r"Pattern (\\d+) \\('[^']*'\\) found in file '[^']*in(\\d+)\\.bin' "
        r"at offset (\\d+)", text
    ):
        got.add((int(m.group(2)), int(m.group(3)), int(m.group(1))))
    # disjoint ownership: this host decoded ONLY its own files
    # (worker 0 of proc p owns files p, p+2, ...)
    own_files = {i for i in range(n_files) if i % 2 == pid}
    assert {f for f, _, _ in got} <= own_files, (pid, got)
    assert got == {e for e in want if e[0] in own_files}, (pid, got)
    if pid == 0:
        assert stats_matches(text) == len(want), (text[-500:], len(want))
    # the dense engine's mesh totals already count both processes' lanes:
    # the stats block must not sum them once per process
    text_d = cli_run("dense")
    if pid == 0:
        assert stats_matches(text_d) == len(want), (text_d[-500:], len(want))

    # ---- pattern shards x multi-process: the
    # ("pat", "data") grid built so each process owns ALL pat rows of its
    # data columns — each host feeds only ITS lanes, decodes only ITS
    # events, and the per-host event sets are oracle-exact on disjoint
    # payloads (the union across hosts is then exact by construction).
    from pattern_matching.runtime.buffers import StreamState
    from pattern_matching.runtime.session import MatchSession

    sessP = MatchSession(
        table, max_chunks=256, chunk_len=64, engine="bloom",
        mesh="all", pat_shards=2,
    )
    grid = sessP._pshard_ctx.mesh.devices
    for col in range(grid.shape[1]):
        owners = {d.process_index for d in grid[:, col]}
        assert len(owners) == 1, (col, owners)  # column-per-process
    payload = bytearray(
        np.random.RandomState(1000 + pid).randint(
            0, 256, size=6000
        ).astype(np.uint8)
    )
    # 6000 bytes fit this host's 128-lane x 64 B shard in one batch
    for pos in (17 + pid, 3000, 5800 - 13 * pid):
        payload[pos : pos + 8] = pats[(pos + pid) % 16]
    payload = bytes(payload)
    buf = sessP.new_buffer()
    assert buf.max_chunks == sessP.local_chunks
    buf.add_stream(io.BytesIO(payload), StreamState(file_id=pid))
    batch = buf.to_batch()
    bm = sessP.decode(batch, sessP.scan(batch))
    got_p = sorted(
        (e, p) for ev in bm.events for (e, p) in ev.expand()
    )
    want_p = sorted(match_python(pats, payload))
    assert got_p == want_p, (pid, len(got_p), len(want_p))

    # both processes know both payload seeds, so each can compute the
    # GLOBAL oracle expectation the psum/allreduce totals must equal
    def payload_of(p):
        pl = bytearray(np.random.RandomState(1000 + p).randint(
            0, 256, size=6000).astype(np.uint8))
        for pos in (17 + p, 3000, 5800 - 13 * p):
            pl[pos : pos + 8] = pats[(pos + p) % 16]
        return bytes(pl)

    want_events_global = sum(
        len({e for e, _ in match_python(pats, payload_of(p))})
        for p in range(2)
    )

    def run_arm(sess):
        b2 = sess.new_buffer()
        assert b2.max_chunks == sess.local_chunks
        b2.add_stream(io.BytesIO(payload), StreamState(file_id=pid))
        bt = b2.to_batch()
        return bt, sess.decode(bt, sess.scan(bt))

    # round 5: MeshDeviceVerifier ACROSS processes —
    # exercises _assemble's contiguous-lane rebasing on a 2-proc mesh
    sessV = MatchSession(table, max_chunks=256, chunk_len=64,
                         engine="bloom", mesh="all", verify="device")
    assert sessV._dvf_mesh is not None
    _bt, bmV = run_arm(sessV)
    got_v = sorted((e, p) for ev in bmV.events for (e, p) in ev.expand())
    assert got_v == want_p, (pid, len(got_v), len(want_p))
    assert bmV.total == want_events_global, (bmV.total, want_events_global)

    # round 5: pshard device-verify EVENTS across
    # processes — per-shard walks + host-local cross-shard event merge
    sessPV = MatchSession(table, max_chunks=256, chunk_len=64,
                          engine="bloom", mesh="all", pat_shards=2,
                          verify="device")
    assert sessPV._dvf_pshard is not None
    _bt, bmPV = run_arm(sessPV)
    got_pv = sorted((e, p) for ev in bmPV.events for (e, p) in ev.expand())
    assert got_pv == want_p, (pid, len(got_pv), len(want_p))
    assert bmPV.total == want_events_global, (
        bmPV.total, want_events_global)

    # round 5: the DENSE engine across processes —
    # per-device compaction keeps tuples lane-sharded so each host
    # decodes exactly the lanes it fed (previously rejected outright)
    sessD = MatchSession(table, max_chunks=256, chunk_len=64,
                         engine="dense", mesh="all")
    assert sessD._dense_step is not None
    btD, bmD = run_arm(sessD)
    got_d = sorted((e, p) for ev in bmD.events for (e, p) in ev.expand())
    assert got_d == want_p, (pid, len(got_d), len(want_p))
    assert bmD.total == want_events_global, (bmD.total, want_events_global)
    n_ev_d, gcD = sessD.decode_counts(btD, sessD.scan(btD))
    assert n_ev_d == want_events_global
    assert int(gcD.sum()) == want_events_global

    print(f"proc {pid} OK total={t} cli_events={len(got)} "
          f"pshard_events={len(got_p)} dv={len(got_v)} "
          f"pdv={len(got_pv)} dense={len(got_d)}", flush=True)
    """
)


@pytest.mark.skipif(
    os.environ.get("TPM_TEST_GPU"), reason="multi-process sim is CPU-only"
)
def test_two_process_sharded_bloom(tmp_path):
    import socket

    with socket.socket() as sock:  # a free port: collisions hang the init
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(i), port, str(tmp_path)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            cwd=root,
            env=env,
        )
        for i in range(2)
    ]
    outs = []
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=900)
        outs.append((p.returncode, out.decode()))
    for i, (rc, out) in enumerate(outs):
        assert rc == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i} OK" in out
