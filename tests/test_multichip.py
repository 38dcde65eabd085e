"""Multi-chip sharding tests on the simulated 8-device CPU mesh.

Validates: lane-sharded scan produces identical results to single-device,
and per-group count reduction is globally correct (the psum workload)."""

import io

import jax
import numpy as np
import pytest

from pattern_matching.core.dfa import compile_patterns
from pattern_matching.core.oracle import match_python
from pattern_matching.ops.table import DeviceTable
from pattern_matching.parallel.mesh import MeshContext, make_mesh, make_sharded_scan_step
from pattern_matching.runtime.buffers import DataBuffer, StreamState
from pattern_matching.runtime.session import MatchSession
from tests.fixtures import planted_binary


@pytest.fixture(scope="module")
def mesh_ctx():
    if len(jax.devices()) < 2:
        pytest.skip("needs multi-device (simulated CPU mesh)")
    return MeshContext(make_mesh())


def test_sharded_scan_matches_oracle(mesh_ctx):
    patterns = [b"\xde\xad\xbe\xef", b"needle!", b"abc"]
    data, _ = planted_binary(21, 1 << 14, patterns, 30)
    table = compile_patterns(patterns)

    C, B = 64, 256  # 64 lanes over 8 devices
    halo = table.max_pat_len - 1
    buf = DataBuffer(C, B, halo)
    buf.add_stream(io.BytesIO(data), StreamState(file_id=0))
    batch = buf.to_batch()

    dev = DeviceTable.put(table, mesh_ctx.replicated)
    step = make_sharded_scan_step(
        mesh_ctx, dev, halo=halo, max_results=16, num_groups=table.num_groups
    )
    data_sh = jax.device_put(batch.data, mesh_ctx.lane_sharded)
    counts, slot_state, slot_pos, gcounts = step(
        dev.table_flat, dev.state_gid, data_sh, batch.start_t, batch.end_t
    )

    # decode to (end_offset, pid) and compare to oracle
    counts = np.asarray(counts)
    slot_state = np.asarray(slot_state)
    slot_pos = np.asarray(slot_pos)
    groups = table.groups_as_lists()
    sgid = table.state_gid
    got = []
    for ln in range(C):
        for r in range(min(counts[ln], 16)):
            st = slot_state[ln, r]
            off = int(batch.base_off[ln]) + int(slot_pos[ln, r])
            for pid in groups[sgid[st]]:
                got.append((off, pid))
    assert sorted(got) == sorted(match_python(patterns, data))

    # group counts: total events == number of matching positions
    ev = match_python(patterns, data)
    assert int(np.asarray(gcounts).sum()) == len({off for off, _ in ev})


def test_sharded_equals_unsharded(mesh_ctx):
    patterns = [b"ab", b"bc"]
    data = b"abcabc" * 100
    table = compile_patterns(patterns)
    # ~21 matches per 64-byte lane on this corpus: R must cover it (find()
    # now fails loud on slot overflow instead of silently truncating)
    R = 64
    sess = MatchSession(table, max_chunks=16, chunk_len=64, engine="dense",
                        max_results=R)
    expect = sess.find(data)

    dev = DeviceTable.put(table, mesh_ctx.replicated)
    halo = table.max_pat_len - 1
    buf = DataBuffer(16, 64, halo)
    buf.add_stream(io.BytesIO(data), StreamState(file_id=0))
    batch = buf.to_batch()
    step = make_sharded_scan_step(
        mesh_ctx, dev, halo=halo, max_results=R, num_groups=table.num_groups
    )
    counts, slot_state, slot_pos, _ = step(
        dev.table_flat,
        dev.state_gid,
        jax.device_put(batch.data, mesh_ctx.lane_sharded),
        batch.start_t,
        batch.end_t,
    )
    groups = table.groups_as_lists()
    got = []
    for ln in range(16):
        for r in range(min(int(counts[ln]), R)):
            st = int(np.asarray(slot_state)[ln, r])
            off = int(batch.base_off[ln]) + int(np.asarray(slot_pos)[ln, r])
            for pid in groups[table.state_gid[st]]:
                got.append((off, pid))
    assert sorted(got) == expect


def test_sharded_bloom_equals_unsharded():
    # the flagship bloom engine under shard_map: survivor bitmap and total
    # must be identical to the single-device probe
    import jax
    import numpy as np

    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.ops.bloom import BloomFilterTable, _hits_jit
    from pattern_matching.parallel.mesh import (
        MeshContext,
        make_mesh,
        make_sharded_bloom_step,
    )

    rng = np.random.RandomState(3)
    pats = [bytes(rng.randint(0, 256, size=8).astype(np.uint8))
            for _ in range(16)]
    table = compile_patterns(pats)
    bft = BloomFilterTable.from_table(table)

    n_dev = 8
    lanes = 128 * n_dev  # multiple of the 128-lane tile per shard
    T = 256
    data = rng.randint(0, 256, size=(lanes, T)).astype(np.uint8)
    for ln in (0, 200, 1023):  # plant occurrences
        data[ln, 100:108] = np.frombuffer(pats[ln % 16], np.uint8)
    bounds = np.stack([np.zeros(lanes, np.int32),
                       np.full(lanes, T, np.int32)])

    total1, bits1 = _hits_jit(
        jax.device_put(data), jax.device_put(bounds),
        jax.device_put(bft.words), cfg=bft.cfg,
    )

    ctx = MeshContext(make_mesh(jax.devices()[:n_dev]))
    bloom = bft.put(ctx.replicated)
    step = make_sharded_bloom_step(ctx, bloom)
    totalN, bitsN = step(
        bloom.words,
        jax.device_put(data, ctx.lane_sharded),
        jax.device_put(bounds, ctx.lane_sharded2d),
    )
    assert int(totalN[0]) == int(total1[0]) > 0
    np.testing.assert_array_equal(np.asarray(bitsN), np.asarray(bits1))


def test_session_mesh_product_path(mesh_ctx):
    # the multi-chip path must be reachable from
    # MatchSession itself, both engines, oracle-exact
    patterns = [b"\xde\xad\xbe\xef", b"needle!", b"abcab"]
    data, _ = planted_binary(77, 1 << 14, patterns, 25)
    expect = sorted(match_python(patterns, data))
    for engine in ("bloom", "dense"):
        sess = MatchSession(
            compile_patterns(patterns),
            max_chunks=16,
            chunk_len=128,
            engine=engine,
            mesh=mesh_ctx,
        )
        # lane alignment: bloom pads to mesh*128, dense to mesh size
        assert sess.max_chunks % mesh_ctx.num_devices == 0
        if engine == "bloom":
            assert sess.max_chunks % (mesh_ctx.num_devices * 128) == 0
        assert sess.find(data) == expect


def test_session_mesh_bloom_group_counts(mesh_ctx):
    # BASELINE config 5 on the flagship engine: per-group counts from the
    # bloom engine's verified events must equal the dense psum path
    import io

    patterns = [b" alpha ", b" beta ", b" gamma "]
    words = (b" alpha  beta  alpha  gamma " * 40) + b" beta "
    table = compile_patterns(patterns)

    sess_b = MatchSession(table, max_chunks=16, chunk_len=64,
                          engine="bloom", mesh=mesh_ctx)
    got = np.zeros(table.num_groups, np.int64)
    for bm in sess_b.scan_stream(io.BytesIO(words)):
        got += sess_b.event_group_counts(bm)

    # dense reference: the sharded psum step
    from pattern_matching.ops.table import DeviceTable

    halo = table.max_pat_len - 1
    C = 8 * mesh_ctx.num_devices
    buf = DataBuffer(C, 64, halo)
    buf.add_stream(io.BytesIO(words), StreamState(file_id=0))
    batch = buf.to_batch()
    dev = DeviceTable.put(table, mesh_ctx.replicated)
    step = make_sharded_scan_step(
        mesh_ctx, dev, halo=halo, max_results=16,
        num_groups=table.num_groups,
    )
    *_, gcounts = step(
        dev.table_flat, dev.state_gid,
        jax.device_put(batch.data, mesh_ctx.lane_sharded),
        batch.start_t, batch.end_t,
    )
    np.testing.assert_array_equal(got, np.asarray(gcounts))

    # host-count allreduce helper is a no-op single-process
    from pattern_matching.parallel.mesh import allreduce_host_counts

    np.testing.assert_array_equal(allreduce_host_counts(got), got)


def test_session_mesh_device_verify_events(mesh_ctx):
    # verify='device' composes with mesh= — the full
    # verify pipeline runs per shard under shard_map, events come back
    # lane-sharded, and the session decode is oracle-exact with zero host
    # CPU in the verify loop
    patterns = [b"\xde\xad\xbe\xef", b"needle!", b"abcab"]
    data, _ = planted_binary(5, 1 << 14, patterns, 40)
    expect = sorted(match_python(patterns, data))
    sess = MatchSession(
        compile_patterns(patterns),
        max_chunks=16,
        chunk_len=128,
        engine="bloom",
        mesh=mesh_ctx,
        verify="device",
    )
    assert sess._dvf_mesh is not None
    assert sess.find(data) == expect

    # counts path: globally-reduced gcounts from the same step must match
    # host-verified event counts
    buf = sess.new_buffer()
    buf.add_stream(io.BytesIO(data), StreamState(file_id=0))
    batch = buf.to_batch()
    comp = sess.scan(batch)
    n_ev, gc = sess.decode_counts(batch, comp)
    want_pos = {off for off, _ in match_python(patterns, data)}
    assert n_ev == len(want_pos)
    assert int(gc.sum()) == len(want_pos)


def test_mesh_device_verify_event_overflow_retry(mesh_ctx):
    # match-dense input: the first dispatch's event capacity overflows and
    # the replicated `needs` drives an SPMD-safe retry with the exact need
    patterns = [b"ababab"]
    data = b"ab" * (1 << 13)  # a match every 2 bytes
    table = compile_patterns(patterns)
    expect = sorted(match_python(patterns, data))
    sess = MatchSession(
        table, max_chunks=16, chunk_len=256,
        engine="bloom", mesh=mesh_ctx, verify="device",
    )
    got = sess.find(data)
    assert got == expect and len(expect) > 1000


def test_sharded_bloom_rejects_unaligned_lanes(mesh_ctx):
    # an unaligned per-shard lane count would silently
    # corrupt the bitmap's column->lane mapping; it must be a loud error
    from pattern_matching.ops.bloom import BloomFilterTable
    from pattern_matching.parallel.mesh import make_sharded_bloom_step

    table = compile_patterns([b"abcdef"])
    bft = BloomFilterTable.from_table(table)
    step = make_sharded_bloom_step(mesh_ctx, bft.put(mesh_ctx.replicated))
    n = mesh_ctx.num_devices
    lanes = 64 * n  # 64 per shard: NOT a multiple of 128
    data = np.zeros((lanes, 256), np.uint8)
    bounds = np.stack([np.zeros(lanes, np.int32),
                       np.full(lanes, 256, np.int32)])
    with pytest.raises(ValueError, match="128"):
        step(
            bft.put(mesh_ctx.replicated).words,
            jax.device_put(data, mesh_ctx.lane_sharded),
            jax.device_put(bounds, mesh_ctx.lane_sharded2d),
        )


def test_sharded_bloom_count_step_all_device(mesh_ctx):
    # config 5 on the bloom engine
    # with NO host verify in the loop — probe + device verify + psum
    # group counts in one jit, agreeing exactly with the host-verified
    # session counts
    import io

    from pattern_matching.parallel.mesh import (
        make_sharded_bloom_count_step,
    )

    patterns = [b" alpha ", b" beta ", b" gamma "]
    words = (b" alpha  beta  alpha  gamma " * 40) + b" beta "
    table = compile_patterns(patterns)

    sess = MatchSession(table, max_chunks=mesh_ctx.num_devices * 128,
                        chunk_len=64, engine="bloom", mesh=mesh_ctx)
    want = np.zeros(table.num_groups, np.int64)
    n_want = 0
    for bm in sess.scan_stream(io.BytesIO(words)):
        want += sess.event_group_counts(bm)
        n_want += bm.total

    step = make_sharded_bloom_count_step(
        mesh_ctx, sess._bloom, table, halo=sess.halo, k_cand=512, k_ev=512
    )
    buf = sess.new_buffer()
    buf.add_stream(io.BytesIO(words), StreamState(file_id=0))
    b = buf.to_batch()
    gcounts, n_ev, flags, _needs = step(
        sess._bloom.words,
        jax.device_put(
            np.ascontiguousarray(table.goto_signed).reshape(-1),
            mesh_ctx.replicated,
        ),
        jax.device_put(table.state_gid.astype(np.int32),
                       mesh_ctx.replicated),
        jax.device_put(b.data, mesh_ctx.lane_sharded),
        jax.device_put(np.stack([b.start_t, b.end_t]),
                       mesh_ctx.lane_sharded2d),
    )
    assert int(np.asarray(flags)) == 0
    assert int(np.asarray(n_ev)) == n_want
    np.testing.assert_array_equal(np.asarray(gcounts).astype(np.int64), want)


def test_ushort_session_on_mesh(mesh_ctx):
    # the AC_ushorts workload gets the flagship
    # parallelism — alphabet-2048 sessions on the mesh (both engines,
    # plus device verify and pattern shards), oracle-exact in token units
    from pattern_matching.core.dfa import ALPHABET_USHORT, AhoCorasick

    rng = np.random.RandomState(17)
    pat_list = [
        tuple(int(x) for x in rng.randint(0, 2048, size=rng.randint(2, 6)))
        for _ in range(8)
    ]
    ac = AhoCorasick(ALPHABET_USHORT)
    for p in pat_list:
        ac.add_pattern(p)
    table = ac.compile()
    seq = rng.randint(0, 2048, size=4000)
    for pos in range(10, 3900, 333):
        p = pat_list[pos % len(pat_list)]
        seq[pos : pos + len(p)] = p
    want = sorted(match_python(pat_list, seq.tolist()))
    text = (",".join(str(int(x)) for x in seq)).encode()
    for kw in (
        dict(engine="bloom"),
        dict(engine="bloom", verify="device"),
        dict(engine="dense", max_results=64),
        dict(engine="bloom", pat_shards=2),
    ):
        sess = MatchSession(
            table, max_chunks=16, chunk_len=64, mesh=mesh_ctx, **kw
        )
        assert sess.find(text) == want, kw


def test_ushort_cli_mesh(tmp_path, capsys):
    # the product path: --ushort --mesh all through the CLI
    from pattern_matching.cli import main

    sig = tmp_path / "sigs.txt"
    sig.write_text("40,32,287; 3; alpha\n7,7; 2; beta\n")
    flow = tmp_path / "flow.txt"
    flow.write_text("9, 40, 32, 287, 1, 7,7,7\n")
    rc = main([
        "-f", str(flow), "-p", str(sig), "--ushort", "-v",
        "-B", "64", "-G", "16", "-w", "1", "--mesh", "all",
        "--engine", "bloom",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Pattern 0 ('alpha')" in out
    assert out.count("Pattern 1 ('beta')") == 2
    assert "Matches:             3" in out


def test_sharded_bloom_counter_auto_retry(mesh_ctx):
    # a match-dense batch overflows the initial
    # per-shard capacities; ShardedBloomCounter rescans the SAME batch at
    # the exact reported needs and returns oracle-exact counts with no
    # manual tuning
    from pattern_matching.parallel.mesh import ShardedBloomCounter

    patterns = [b"ababab"]
    table = compile_patterns(patterns)
    n = mesh_ctx.num_devices
    data = b"ab" * (n * 128 * 32)  # a match every 2 bytes
    want_n = len(match_python(patterns, data))
    sess = MatchSession(table, max_chunks=n * 128, chunk_len=64,
                        engine="bloom", mesh=mesh_ctx)
    counter = ShardedBloomCounter(
        mesh_ctx, sess._bloom, table, halo=sess.halo,
        k_cand=256, k_ev=256,
        gram_keys=sess.bloom_table.gram_keys, k_walk=256,
    )
    buf = sess.new_buffer()
    buf.add_stream(io.BytesIO(data), StreamState(file_id=0))
    b = buf.to_batch()
    gcounts, n_ev = counter.count(
        jax.device_put(b.data, mesh_ctx.lane_sharded),
        jax.device_put(np.stack([b.start_t, b.end_t]),
                       mesh_ctx.lane_sharded2d),
    )
    assert n_ev == want_n > 1000
    assert int(gcounts.sum()) == want_n
    # the retry actually fired and the grown capacities are sticky
    assert counter.k_ev > 256
    g2, n2 = counter.count(
        jax.device_put(b.data, mesh_ctx.lane_sharded),
        jax.device_put(np.stack([b.start_t, b.end_t]),
                       mesh_ctx.lane_sharded2d),
    )
    assert n2 == want_n and int(g2.sum()) == want_n


def test_sharded_count_step_with_refinement(mesh_ctx):
    # the psum count path with the exact-gram refinement stage enabled:
    # identical gcounts, flags stay clean with a small k_walk (random
    # words -> few true grams)
    import io

    import jax

    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.parallel.mesh import (
        make_sharded_bloom_count_step,
    )
    from pattern_matching.runtime.buffers import StreamState
    from pattern_matching.runtime.session import MatchSession

    rng = np.random.RandomState(21)
    pats = [bytes(rng.randint(97, 123, size=6).astype(np.uint8))
            for _ in range(30)]
    words = bytearray(rng.randint(97, 123, size=mesh_ctx.num_devices
                                  * 128 * 64).astype(np.uint8))
    for pos in range(50, len(words) - 6, 977):
        words[pos : pos + 6] = pats[pos % 30]
    words = bytes(words)
    table = compile_patterns(pats)
    sess = MatchSession(table, max_chunks=mesh_ctx.num_devices * 128,
                        chunk_len=64, engine="bloom", mesh=mesh_ctx)
    want = np.zeros(table.num_groups, np.int64)
    for bm in sess.scan_stream(io.BytesIO(words)):
        want += sess.event_group_counts(bm)

    step = make_sharded_bloom_count_step(
        mesh_ctx, sess._bloom, table, halo=sess.halo, k_cand=2048,
        k_ev=2048, gram_keys=sess.bloom_table.gram_keys, k_walk=512,
    )
    buf = sess.new_buffer()
    buf.add_stream(io.BytesIO(words), StreamState(file_id=0))
    b = buf.to_batch()
    gcounts, n_ev, flags, _needs = step(
        sess._bloom.words,
        jax.device_put(
            np.ascontiguousarray(table.goto_signed).reshape(-1),
            mesh_ctx.replicated,
        ),
        jax.device_put(table.state_gid.astype(np.int32),
                       mesh_ctx.replicated),
        jax.device_put(b.data, mesh_ctx.lane_sharded),
        jax.device_put(np.stack([b.start_t, b.end_t]),
                       mesh_ctx.lane_sharded2d),
    )
    assert int(flags) == 0
    np.testing.assert_array_equal(np.asarray(gcounts).astype(np.int64),
                                  want)
