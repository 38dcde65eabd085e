"""Pattern-set sharding tests (parallel/pshard.py) on the CPU mesh.

Validates the model-parallel axis: S per-shard filters under one common
config must produce the SAME union survivor bitmap, event set, and
per-pattern counts as the single-filter engine — single-device (S probes
in one jit) and on the ("pat", "data") 2D mesh."""

import io

import jax
import numpy as np
import pytest

from pattern_matching.core.dfa import compile_patterns
from pattern_matching.core.oracle import match_python
from pattern_matching.parallel.pshard import (
    Mesh2DContext,
    ShardedBloom,
    global_pattern_counts,
    make_pattern_sharded_count_step,
    pad_shard_tables,
    shard_pattern_ids,
)
from pattern_matching.runtime.buffers import StreamState
from pattern_matching.runtime.session import MatchSession
from tests.fixtures import planted_binary


def _patterns(n=24, seed=7):
    rng = np.random.RandomState(seed)
    # mixed lengths (6..12) so the longest-first deal is exercised and
    # q/w choices are constrained by the global minimum
    return [
        bytes(rng.randint(0, 256, size=rng.randint(6, 13)).astype(np.uint8))
        for _ in range(n)
    ]


def _oracle_set(patterns, data):
    return {(off, pid) for off, pid in match_python(patterns, data)}


def _event_set(events):
    got = set()
    for ev in events:
        for off, pid in ev.expand():
            got.add((off, pid))
    return got


def test_shard_pattern_ids_balanced():
    lens = [3, 9, 5, 7, 4, 8, 6, 10]
    parts = shard_pattern_ids(lens, 3)
    assert sorted(np.concatenate(parts).tolist()) == list(range(8))
    # globally shortest pattern (len 3, id 0) is dealt last: shard (N-1)%S
    assert 0 in parts[(len(lens) - 1) % 3]
    sizes = [len(p) for p in parts]
    assert max(sizes) - min(sizes) <= 1


def test_sharded_build_common_config_and_coverage():
    pats = _patterns()
    sb = ShardedBloom.build([list(p) for p in pats], 4)
    assert sb.words.shape[0] == 4
    assert sb.n_shards == 4
    # every pattern in exactly one shard
    assert sorted(np.concatenate(sb.parts).tolist()) == list(range(len(pats)))
    # shard filters differ (different grams) under one config
    assert not np.array_equal(sb.words[0], sb.words[1])


def test_sharded_session_matches_oracle_single_device():
    pats = _patterns()
    data, _ = planted_binary(11, 1 << 14, pats, 40)
    table = compile_patterns(pats)

    sess1 = MatchSession(table, max_chunks=128, chunk_len=256,
                         engine="bloom")
    sessS = MatchSession(table, max_chunks=128, chunk_len=256,
                         engine="bloom", pat_shards=4)
    assert sessS.pat_shards == 4
    want = _oracle_set(pats, data)
    got1 = set(sess1.find(data))
    gotS = set(sessS.find(data))
    assert got1 == want
    assert gotS == want


def test_sharded_union_bitmap_superset_of_single():
    # the union bitmap must cover every TRUE gram position: compare
    # event sets batch-by-batch through scan/decode
    pats = _patterns(n=12, seed=3)
    data, _ = planted_binary(5, 1 << 13, pats, 25)
    table = compile_patterns(pats)
    sess = MatchSession(table, max_chunks=64, chunk_len=256,
                        engine="bloom", pat_shards=3)
    buf = sess.new_buffer()
    buf.add_stream(io.BytesIO(data), StreamState(file_id=0))
    bm = sess.scan_and_decode(buf.to_batch())
    assert _event_set(bm.events) == _oracle_set(pats, data)


@pytest.fixture(scope="module")
def devices8():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device simulated CPU mesh")
    return jax.devices()[:8]


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_session_2d_mesh_matches_oracle(devices8, n_shards):
    pats = _patterns()
    data, _ = planted_binary(13, 1 << 14, pats, 40)
    table = compile_patterns(pats)
    from pattern_matching.parallel.mesh import make_mesh

    mesh = make_mesh(devices8)
    sess = MatchSession(table, max_chunks=1024, chunk_len=128,
                        engine="bloom", mesh=mesh, pat_shards=n_shards)
    # lane alignment: data_size * 128 lanes
    assert sess.max_chunks % ((8 // n_shards) * 128) == 0
    got = set(sess.find(data))
    assert got == _oracle_set(pats, data)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_pshard_device_verify_events_oracle(devices8, n_shards):
    # device-exact EVENTS on the ("pat","data") mesh —
    # the full verify pipeline runs per shard against 1/S dense tables,
    # events merge across shards at host decode
    pats = _patterns(n=16, seed=41)
    data, _ = planted_binary(19, 1 << 14, pats, 40)
    table = compile_patterns(pats)
    from pattern_matching.parallel.mesh import make_mesh

    sess = MatchSession(table, max_chunks=1024, chunk_len=128,
                        engine="bloom", mesh=make_mesh(devices8),
                        pat_shards=n_shards, verify="device")
    assert sess._dvf_pshard is not None
    got = set(sess.find(data))
    assert got == _oracle_set(pats, data)


def test_pshard_device_verify_cross_shard_coterminators(devices8):
    # patterns that co-terminate at the SAME end position but live in
    # DIFFERENT shards must merge into ONE MatchEvent whose pattern set
    # is the global co-terminating group
    pats = [b"wxyzabcd", b"abcd", b"qrst", b"zabcd"]
    table = compile_patterns(pats)
    sb = ShardedBloom.from_table(table, 2)
    shard_of = {}
    for s, part in enumerate(sb.parts):
        for pid in part:
            shard_of[int(pid)] = s
    # the suffix family must actually span both shards for the test to
    # bite (longest-first deal: 0 -> shard 0, 3 -> shard 1)
    assert shard_of[0] != shard_of[3], shard_of
    from pattern_matching.parallel.mesh import make_mesh

    payload = bytearray(b"." * 4000)
    payload[100:108] = pats[0]  # ends pats 0, 1, 3 at offset 107
    payload[900:904] = pats[1]  # pat 1 alone
    payload[2000:2005] = pats[3]  # ends pats 3, 1
    payload = bytes(payload)
    sess = MatchSession(table, max_chunks=256, chunk_len=64,
                        engine="bloom", mesh=make_mesh(devices8),
                        bloom_table=sb, verify="device")
    assert sess._dvf_pshard is not None
    buf = sess.new_buffer()
    buf.add_stream(io.BytesIO(payload), StreamState(file_id=0))
    b = buf.to_batch()
    bm = sess.decode(b, sess.scan(b))
    assert _event_set(bm.events) == _oracle_set(pats, payload)
    by_end = {ev.end_offset: ev for ev in bm.events}
    assert len(by_end) == len(bm.events)  # merged: one event per end
    assert by_end[107].pattern_indices == [0, 1, 3]
    assert by_end[107].gid == sess._gid_of_pidset[(0, 1, 3)]
    assert bm.total == len(bm.events)
    # counts through the same merged path
    n_ev, gcounts = sess.decode_counts(b, sess.scan(b))
    assert n_ev == len(bm.events)
    want = np.zeros(table.num_groups, np.int64)
    for ev in bm.events:
        want[ev.gid] += 1
    np.testing.assert_array_equal(gcounts, want)


def test_pshard_device_verify_capacity_retry(devices8):
    # a match-dense batch must overflow the first event capacity and
    # retry (SPMD-safe replicated needs), staying oracle-exact
    pats = [b" the ", b" and ", b" of the ", b" to "]
    words = (b" the quick and the lazy of the to and the " * 400)
    table = compile_patterns(pats)
    from pattern_matching.parallel.mesh import make_mesh

    sess = MatchSession(table, max_chunks=512, chunk_len=64,
                        engine="bloom", mesh=make_mesh(devices8),
                        pat_shards=2, verify="device")
    assert sess._dvf_pshard is not None
    buf = sess.new_buffer()
    buf.add_stream(io.BytesIO(words), StreamState(file_id=0))
    b = buf.to_batch()
    bm = sess.decode(b, sess.scan(b))
    assert _event_set(bm.events) == _oracle_set(pats, words)


def test_sharded_2d_mesh_bitmap_equals_single_device(devices8):
    # the union bitmap from the ("pat","data") mesh must be bit-identical
    # to the single-device S-probe union
    pats = _patterns(n=16, seed=21)
    table = compile_patterns(pats)
    sb = ShardedBloom.from_table(table, 2)

    rng = np.random.RandomState(4)
    lanes, T = 128 * 4, 256
    data = rng.randint(0, 256, size=(lanes, T)).astype(np.uint8)
    for ln in (0, 100, 300):
        p = pats[ln % len(pats)]
        data[ln, 50 : 50 + len(p)] = np.frombuffer(p, np.uint8)
    bounds = np.stack([np.zeros(lanes, np.int32),
                       np.full(lanes, T, np.int32)])

    dev1 = sb.put()
    h1 = dev1.hits(jax.device_put(data), jax.device_put(bounds))

    ctx2 = Mesh2DContext.build(devices8, 2)  # 2 pat x 4 data
    from pattern_matching.parallel.pshard import (
        make_pattern_sharded_bloom_step,
    )

    devM = sb.put(ctx2.pat_sharded)
    step = make_pattern_sharded_bloom_step(ctx2, devM)
    totalM, bitsM = step(
        devM.words,
        jax.device_put(data, ctx2.lane_sharded),
        jax.device_put(bounds, ctx2.lane_sharded2d),
    )
    assert int(np.asarray(totalM)[0]) == int(np.asarray(h1.meta)[0]) > 0
    np.testing.assert_array_equal(np.asarray(bitsM), np.asarray(h1.bits))


def test_pattern_sharded_count_step(devices8):
    # the all-device count path with the TABLE sharded over "pat":
    # global per-pattern counts must equal the oracle's
    pats = [b" alpha ", b" beta ", b" gamma ", b" delta "]
    words = (b" alpha  beta  alpha  gamma " * 30) + b" delta  beta "
    table = compile_patterns(pats)
    sb = ShardedBloom.from_table(table, 2)
    shard_tables = [
        compile_patterns([pats[i] for i in part]) for part in sb.parts
    ]

    ctx2 = Mesh2DContext.build(devices8, 2)
    dev = sb.put(ctx2.pat_sharded)
    sess = MatchSession(table, max_chunks=512, chunk_len=64,
                        engine="bloom", bloom_table=sb)
    step = make_pattern_sharded_count_step(
        ctx2, dev, shard_tables, halo=sess.halo, k_cand=512, k_ev=512
    )
    flat, gids, _lmax, _gmax = pad_shard_tables(shard_tables)

    buf = sess.new_buffer()
    buf.add_stream(io.BytesIO(words), StreamState(file_id=0))
    b = buf.to_batch()
    gcounts, n_ev, flags = step(
        dev.words,
        jax.device_put(flat, ctx2.pat_sharded),
        jax.device_put(gids, ctx2.pat_sharded),
        jax.device_put(b.data, ctx2.lane_sharded),
        jax.device_put(np.stack([b.start_t, b.end_t]),
                       ctx2.lane_sharded2d),
    )
    assert not np.asarray(flags).any()
    pc = global_pattern_counts(sb, shard_tables, gcounts)
    want = np.zeros(len(pats), np.int64)
    for _off, pid in match_python(pats, words):
        want[pid] += 1
    np.testing.assert_array_equal(pc, want)
    assert int(np.asarray(n_ev).sum()) == int(want.sum())


def test_sharded_bloom_save_load_roundtrip(tmp_path):
    pats = _patterns(n=10, seed=9)
    table = compile_patterns(pats)
    sb = ShardedBloom.from_table(table, 3)
    path = str(tmp_path / "psb.npz")
    sb.save(path)
    sb2 = ShardedBloom.load(path)
    assert sb2.cfg == sb.cfg
    np.testing.assert_array_equal(sb2.words, sb.words)
    assert [p.tolist() for p in sb2.parts] == [p.tolist() for p in sb.parts]
    assert sb2.n_grams == sb.n_grams

    # a flat dump must be rejected with a clear error
    from pattern_matching.ops.bloom import BloomFilterTable

    flat = BloomFilterTable.from_table(table)
    fpath = str(tmp_path / "flat.npz")
    flat.save(fpath)
    with pytest.raises(ValueError, match="flat filter"):
        ShardedBloom.load(fpath)


def test_pat_shards_validation():
    pats = _patterns(n=6)
    table = compile_patterns(pats)
    with pytest.raises(ValueError, match="dense"):
        MatchSession(table, engine="dense", pat_shards=2)
    with pytest.raises(ValueError, match="shards"):
        ShardedBloom.from_table(table, 7)  # 7 shards, 6 patterns
    sb = ShardedBloom.from_table(table, 2)
    with pytest.raises(ValueError, match="precompiled"):
        MatchSession(table, engine="bloom", bloom_table=sb, pat_shards=3)
    # pat_shards inferred from a precompiled sharded filter
    sess = MatchSession(table, engine="bloom", bloom_table=sb)
    assert sess.pat_shards == 2


def test_pat_shards_with_device_verify():
    # composition: the union bitmap feeds the device verify stage (which
    # walks the GLOBAL table) — events must stay oracle-exact
    pats = _patterns(n=12, seed=31)
    data, _ = planted_binary(17, 1 << 13, pats, 25)
    table = compile_patterns(pats)
    sess = MatchSession(table, max_chunks=64, chunk_len=256,
                        engine="bloom", pat_shards=3, verify="device")
    assert set(sess.find(data)) == _oracle_set(pats, data)


def test_pattern_sharded_count_step_refined(devices8):
    # per-shard exact-gram refinement on the pat-sharded count path:
    # each device erases union candidates outside ITS shard's gram set;
    # per-pattern counts stay oracle-exact and flags stay clean even
    # with a small per-shard walk capacity
    pats = [b" alpha ", b" beta ", b" gamma ", b" delta "]
    words = (b" alpha  beta  alpha  gamma " * 30) + b" delta  beta "
    table = compile_patterns(pats)
    sb = ShardedBloom.from_table(table, 2)
    assert sb.shard_gram_keys is not None
    shard_tables = [
        compile_patterns([pats[i] for i in part]) for part in sb.parts
    ]
    ctx2 = Mesh2DContext.build(devices8, 2)
    dev = sb.put(ctx2.pat_sharded)
    sess = MatchSession(table, max_chunks=512, chunk_len=64,
                        engine="bloom", bloom_table=sb)
    step = make_pattern_sharded_count_step(
        ctx2, dev, shard_tables, halo=sess.halo, k_cand=512, k_ev=512,
        shard_gram_keys=sb.shard_gram_keys, k_walk=256,
    )
    flat, gids, _lmax, _gmax = pad_shard_tables(shard_tables)
    buf = sess.new_buffer()
    buf.add_stream(io.BytesIO(words), StreamState(file_id=0))
    b = buf.to_batch()
    gcounts, n_ev, flags = step(
        dev.words,
        jax.device_put(flat, ctx2.pat_sharded),
        jax.device_put(gids, ctx2.pat_sharded),
        jax.device_put(b.data, ctx2.lane_sharded),
        jax.device_put(np.stack([b.start_t, b.end_t]),
                       ctx2.lane_sharded2d),
    )
    assert not np.asarray(flags).any()
    pc = global_pattern_counts(sb, shard_tables, gcounts)
    want = np.zeros(len(pats), np.int64)
    for _off, pid in match_python(pats, words):
        want[pid] += 1
    np.testing.assert_array_equal(pc, want)


def test_sharded_save_load_keeps_gram_keys(tmp_path):
    pats = _patterns(n=10, seed=9)
    table = compile_patterns(pats)
    sb = ShardedBloom.from_table(table, 3)
    path = str(tmp_path / "psb_keys.npz")
    sb.save(path)
    sb2 = ShardedBloom.load(path)
    assert len(sb2.shard_gram_keys) == 3
    for a, b in zip(sb.shard_gram_keys, sb2.shard_gram_keys):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sb.gram_keys, sb2.gram_keys)
