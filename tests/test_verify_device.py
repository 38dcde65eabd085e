"""Device-side verify stage (ops/verify_device.py): exact parity with the
oracle and the host verifier, event-capacity retry, cap fallback, and the
exact device-side group counts. Runs as pure XLA, so the CPU mesh covers it;
the device A/B lives in benchmarks/exp_verify_ab.py."""

import io

import numpy as np
import pytest

from pattern_matching.core.dfa import compile_patterns
from pattern_matching.core.oracle import match_python
from pattern_matching.runtime.buffers import StreamState
from pattern_matching.runtime.session import MatchSession


def oracle(pats, data):
    return sorted(match_python(pats, data))


def test_device_verify_parity_basic():
    pats = [b"he", b"she", b"his", b"hers", b"deadbeef"]
    data = (b"ushers and his deadbeefdeadbeef " * 30) + b"she"
    sess = MatchSession(
        compile_patterns(pats), max_chunks=8, chunk_len=64,
        engine="bloom", verify="device",
    )
    assert sess.verify_mode == "device"
    assert sess.find(data) == oracle(pats, data)


def test_device_verify_sampled_mode_parity():
    # winnowing-sampled candidates attribute/dedupe identically
    rng = np.random.RandomState(5)
    pats = [bytes(rng.randint(0, 256, size=10).astype(np.uint8))
            for _ in range(12)]
    data = bytearray(rng.randint(0, 256, size=6000).astype(np.uint8))
    for pos in (5, 500, 2111, 5985):
        data[pos : pos + 10] = pats[pos % 12]
    data = bytes(data)
    table = compile_patterns(pats)
    sess = MatchSession(
        table, max_chunks=8, chunk_len=128, engine="bloom",
        verify="device", bloom_opts={"mode": "sampled"},
    )
    assert sess.bloom_table.cfg.sampled
    assert sess.find(data) == oracle(pats, data)


def test_device_verify_counts_exact_and_match_dense_retry():
    # match-saturated input: survivors are few (one per tested position)
    # but EVENTS outnumber them, forcing the event-capacity retry path;
    # counts and events must stay exact through it
    pats = [b"aa", b"aaa"]
    data = b"a" * 3000
    table = compile_patterns(pats)
    sess = MatchSession(table, max_chunks=4, chunk_len=1024,
                        engine="bloom", verify="device")
    want = oracle(pats, data)
    assert sess.find(data) == want
    # count path: per-group totals equal the oracle's distinct (end, group)
    buf = sess.new_buffer()
    fobj = io.BytesIO(data)
    stream = StreamState(file_id=0)
    got_total = 0
    gc = None
    while True:
        code, rd = buf.add_stream(fobj, stream)
        if buf.chunks and (code == -1 or rd == 0):
            batch = buf.to_batch()
            t, g = sess.decode_counts(batch, sess.scan(batch))
            got_total += t
            gc = g if gc is None else gc + g
            buf.reset()
        if rd == 0:
            break
    ends = {}
    for off, pid in want:
        ends.setdefault(off, set()).add(pid)
    assert got_total == len(ends)
    assert gc.sum() == len(ends)


def test_device_verify_cap_falls_back_to_host(monkeypatch):
    # past MAX_DEVICE_CAND candidates the device path refuses and decode
    # falls back to the host verifier — exactness is never at risk
    import pattern_matching.ops.verify_device as vd

    monkeypatch.setattr(vd, "MAX_DEVICE_CAND", 2)
    pats = [b"he", b"she"]
    data = b"ushers she he " * 40
    sess = MatchSession(compile_patterns(pats), max_chunks=8, chunk_len=64,
                        engine="bloom", verify="device")
    assert sess.find(data) == oracle(pats, data)


def test_device_verify_nocase():
    from pattern_matching.core.dfa import AhoCorasick

    ac = AhoCorasick(nocase=True)
    ac.add_pattern(b"NeEdLe")
    table = ac.compile()
    sess = MatchSession(table, max_chunks=4, chunk_len=64,
                        engine="bloom", verify="device")
    got = sess.find(b"xx needle yy NEEDLE zz nEEdLe")
    assert [e for e, _ in got] == [8, 18, 28]


def test_device_verify_ushort_alphabet():
    from pattern_matching.core.dfa import ALPHABET_USHORT, AhoCorasick

    ac = AhoCorasick(ALPHABET_USHORT)
    ac.add_pattern([40, 32, 287])
    ac.add_pattern([7, 7])
    table = ac.compile()
    sess = MatchSession(table, max_chunks=4, chunk_len=16,
                        engine="bloom", verify="device")
    got = sess.find(b"9, 40, 32, 287, 1, 7,7,7")
    assert got == [(3, 0), (6, 1), (7, 1)]


def test_device_verify_mesh_composes_pshard():
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs multi-device (simulated CPU mesh)")
    # round 4: verify='device' + mesh= is a supported composition (the
    # MeshDeviceVerifier path, test_multichip.py); round 5 lifted the
    # last rejection — the pat-sharded 2D mesh now runs device events via
    # PshardDeviceVerifier (per-shard walk against each shard's OWN 1/S
    # table + cross-shard co-terminator merge at decode, test_pshard.py)
    sess = MatchSession(
        compile_patterns([b"xy"]), max_chunks=256, chunk_len=64,
        engine="bloom", verify="device", mesh=2,
    )
    assert sess._dvf_mesh is not None
    sess2 = MatchSession(
        compile_patterns([b"xy", b"qrs"]), max_chunks=256,
        chunk_len=64, engine="bloom", verify="device", mesh=2,
        pat_shards=2,
    )
    assert sess2._dvf_pshard is not None
    assert sess2.find(b"aaxybbqrsccxy") == [(3, 0), (8, 1), (12, 0)]


def test_device_verify_streaming_halo_continuity():
    # matches straddling batch seams: the halo rows are candidate rows too,
    # and events must be attributed once with exact absolute offsets
    pats = [b"abcdefgh"]
    data = (b"zz" + b"abcdefgh") * 25
    sess = MatchSession(compile_patterns(pats), max_chunks=2, chunk_len=8,
                        engine="bloom", verify="device")
    assert sess.find(data) == oracle(pats, data)


def test_device_verify_fuzz_small_alphabet():
    # dense-match small-alphabet fuzz: heavy co-termination, many events
    # per candidate window, keep-range dedupe is the load-bearing rule
    rng = np.random.RandomState(21)
    alphabet = np.frombuffer(b"ab", np.uint8)
    pats = sorted({bytes(rng.choice(alphabet, size=rng.randint(2, 7)).astype(np.uint8))
                   for _ in range(10)})
    data = bytes(rng.choice(alphabet, size=4096).astype(np.uint8))
    table = compile_patterns(pats)
    sess = MatchSession(table, max_chunks=8, chunk_len=64,
                        engine="bloom", verify="device")
    assert sess.find(data) == oracle(pats, data)


def test_exact_gram_refinement_active_and_erasing():
    # The session's DeviceVerifier must carry the exact-gram table
    # (bloom_table.gram_keys) and erase bloom-fp candidates: on random
    # data with a weak forced filter, refined survivors (meta[4]) must be
    # far fewer than bloom survivors (meta[2]) — and events still
    # oracle-exact.
    rng = np.random.RandomState(11)
    pats = [bytes(rng.randint(0, 256, size=9).astype(np.uint8))
            for _ in range(300)]
    data = bytearray(rng.randint(0, 256, size=50_000).astype(np.uint8))
    for pos in (77, 5000, 31337):
        data[pos : pos + 9] = pats[pos % 300]
    data = bytes(data)
    sess = MatchSession(
        compile_patterns(pats), max_chunks=16, chunk_len=1024,
        engine="bloom", verify="device",
        # k2 v1 strided: high bloom fp -> plenty for refinement to erase
        bloom_opts={"force": ("strided", 3, 3, 2, 1)},
    )
    assert sess._dvf.exact_meta is not None
    metas = []
    orig = sess._dvf.verify

    def spy(*a, **kw):
        out = orig(*a, **kw)
        metas.append(np.asarray(out[0]))
        return out

    sess._dvf.verify = spy
    assert sess.find(data) == oracle(pats, data)
    n_bloom = sum(int(m[2]) for m in metas)
    n_exact = sum(int(m[4]) for m in metas)
    assert n_bloom > 4 * n_exact, (n_bloom, n_exact)


def test_refinement_equals_unrefined_pipeline():
    # Byte-identical results with and without the exact table, across a
    # randomized mix of planted/absent patterns (the refinement only
    # erases candidates that cannot own a match).
    rng = np.random.RandomState(12)
    for trial in range(4):
        npat = rng.randint(2, 12)
        pats = [
            bytes(rng.randint(0, 4, size=rng.randint(4, 9)).astype(np.uint8))
            for _ in range(npat)
        ]  # tiny alphabet: dense true grams + suffix overlaps
        data = bytes(rng.randint(0, 4, size=8192).astype(np.uint8))
        table = compile_patterns(pats)
        s_ref = MatchSession(table, max_chunks=8, chunk_len=512,
                             engine="bloom", verify="device")
        s_unref = MatchSession(table, max_chunks=8, chunk_len=512,
                               engine="bloom", verify="device")
        s_unref._dvf.exact_meta = None  # disable refinement
        got_r = s_ref.find(data)
        got_u = s_unref.find(data)
        exp = oracle(pats, data)
        assert got_r == exp, trial
        assert got_u == exp, trial


def test_refinement_retry_on_small_sticky_bucket():
    # Force the sticky refined-capacity bucket below the true survivor
    # count: the kernel must flag (bit2) and the verifier retry with the
    # exact need.
    pats = [b"ab"]
    data = b"ab" * 2000  # 2000 true matches, all true grams
    sess = MatchSession(compile_patterns(pats), max_chunks=8,
                        chunk_len=1024, engine="bloom", verify="device")
    assert sess._dvf.exact_meta is not None
    sess._dvf._k_walk = 256  # deliberately too small
    assert sess.find(data) == oracle(pats, data)
    assert sess._dvf._k_walk >= 1000  # sticky adapted to the batch
