"""Probe conformance: the plain-XLA bloom probe (strided and sampled,
byte and ushort alphabets, ragged lanes and rows) must produce the
bit-identical survivor bitmap of an independent NumPy model of the
hash/bank math."""

import numpy as np
import pytest

from pattern_matching.ops.bloom import (
    MASK32,
    BloomConfig,
    BloomFilterTable,
    _hash_fields_np,
    _hits_jit,
)


def _np_bank_hits(m1, m2, words, cfg):
    ok = np.ones(m1.shape, bool)
    for b in range(cfg.kbanks):
        vi, w7, bit = _hash_fields_np(m1, m2, np.uint64(b), cfg.v)
        w = words.view(np.uint32)[b, vi.astype(np.int64), w7.astype(np.int64)]
        ok &= ((w >> bit.astype(np.uint32)) & 1).astype(bool)
    return ok


def _np_pack(hits):
    """[R, Cp] bool -> [R/32, Cp] int32: word w bit b is row w*32+b."""
    R, Cp = hits.shape
    out = np.zeros((R // 32, Cp), np.uint32)
    for b in range(32):
        out |= hits[b::32].astype(np.uint32) << np.uint32(b)
    return out.view(np.int32)


def _np_padded(data, bounds, cfg):
    C, T = data.shape
    tt = cfg.tile_rows
    Tp = -(-T // tt) * tt
    Cp = -(-C // 128) * 128
    d = np.zeros((Cp, Tp), np.uint64)
    d[:C, :T] = data
    if cfg.fold_case:
        m = (d >= 65) & (d <= 90)
        d[m] += 32
    start_t = np.zeros(Cp, np.int64)
    end_t = np.zeros(Cp, np.int64)
    start_t[:C] = bounds[0]
    end_t[:C] = bounds[1]
    return d, start_t, end_t

def np_probe_model(data, bounds, words, cfg):
    """Independent strided-mode bitmap model (pure NumPy, no probe code
    reuse): the gram at row r*stride of every lane, all banks ANDed,
    masked to the lane's span, 32 rows per word."""
    if cfg.sampled:
        return np_sampled_model(data, bounds, words, cfg)
    d, start_t, end_t = _np_padded(data, bounds, cfg)
    Cp, Tp = d.shape
    s, q = cfg.stride, cfg.q
    R = Tp // s
    hits = np.zeros((R, Cp), bool)
    for r in range(R):
        row = r * s
        m1 = np.zeros(Cp, np.uint64)
        m2 = np.zeros(Cp, np.uint64)
        for i in range(q):
            m1 = (m1 + d[:, row + i] * np.uint64(cfg.mix1[i])) & np.uint64(
                MASK32
            )
            m2 = (m2 + d[:, row + i] * np.uint64(cfg.mix2[i])) & np.uint64(
                MASK32
            )
        ok = _np_bank_hits(m1, m2, words, cfg)
        ok &= (row + q <= end_t) & (end_t > start_t)
        hits[r] = ok
    return _np_pack(hits)


def np_sampled_model(data, bounds, words, cfg):
    """Independent winnowing model: a position is tested iff it is the
    rightmost argmin of the selection hash over some w-window (positions
    outside the lane's span hash to INT32_MAX), brute-forced window by
    window."""
    from numpy.lib.stride_tricks import sliding_window_view

    d, start_t, end_t = _np_padded(data, bounds, cfg)
    Cp, Tp = d.shape
    q, w = cfg.q, cfg.w
    ext = np.zeros((Cp, Tp + q - 1), np.uint64)
    ext[:, :Tp] = d
    m1 = np.zeros((Cp, Tp), np.uint64)
    m2 = np.zeros((Cp, Tp), np.uint64)
    for i in range(q):
        m1 = (m1 + ext[:, i : i + Tp] * np.uint64(cfg.mix1[i])) & np.uint64(
            MASK32
        )
        m2 = (m2 + ext[:, i : i + Tp] * np.uint64(cfg.mix2[i])) & np.uint64(
            MASK32
        )
    hs = (m1 ^ (m1 >> np.uint64(13))) & np.uint64(0x7FFFFFFF)
    rows = np.arange(Tp)[None, :]
    valid = (
        (rows >= start_t[:, None])
        & (rows + q <= end_t[:, None])
        & (end_t[:, None] > start_t[:, None])
    )
    inf = np.uint64(0x7FFFFFFF)
    hm = np.where(valid, hs, inf)
    hp = np.full((Cp, Tp + 2 * (w - 1)), inf, np.uint64)
    hp[:, w - 1 : w - 1 + Tp] = hm
    win = sliding_window_view(hp, w, axis=1)  # window u covers u-(w-1)..u
    pick = (w - 1) - np.argmin(win[:, :, ::-1], axis=2)  # rightmost argmin
    pos = np.arange(win.shape[1])[None, :] + pick - (w - 1)
    sel = np.zeros((Cp, Tp), bool)
    lane = np.broadcast_to(np.arange(Cp)[:, None], pos.shape)
    inside = (pos >= 0) & (pos < Tp)
    sel[lane[inside], pos[inside]] = True
    hits = sel & valid & _np_bank_hits(m1, m2, words, cfg)
    return _np_pack(hits.T)


def make_cfg(**kw):
    rng = np.random.RandomState(0)
    q = kw.pop("q")
    return BloomConfig(
        q=q,
        mix1=tuple(int(x) | 1 for x in rng.randint(1, 2**31, size=q)),
        mix2=tuple(int(x) | 1 for x in rng.randint(1, 2**31, size=q)),
        **kw,
    )


VARIANTS = [
    dict(q=4, stride=4, kbanks=4, v=4),
    # fold_case, small gram
    dict(q=2, stride=2, kbanks=10, v=2, fold_case=True),
    # k > 8 banks
    dict(q=4, stride=4, kbanks=11, v=2),
    # v = 16 units
    dict(q=3, stride=3, kbanks=8, v=16),
    # non-pow2 stride
    dict(q=5, stride=7, kbanks=3, v=2),
    # the largest strided filter the chooser builds (k16 x v16 = 128 KiB)
    dict(q=3, stride=5, kbanks=16, v=16, fold_case=True),
]


@pytest.mark.parametrize(
    "kw", VARIANTS, ids=[f"v{i}" for i in range(len(VARIANTS))]
)
def test_kernel_variant_matches_model(kw):
    cfg = make_cfg(**kw)
    rng = np.random.RandomState(1)
    words = rng.randint(
        -(2**31), 2**31, size=(cfg.kbanks, cfg.v, 128)
    ).astype(np.int32)
    C, T = 200, 3 * cfg.tile_rows - 17  # ragged lanes AND rows
    data = rng.randint(0, 256, size=(C, T)).astype(np.uint8)
    bounds = np.stack(
        [
            rng.randint(0, 5, size=C).astype(np.int32),
            rng.randint(T - 5, T + 1, size=C).astype(np.int32),
        ]
    )
    bounds[1, 7] = bounds[0, 7]  # an empty lane
    total, bits = _hits_jit(data, bounds, words, cfg=cfg)
    want = np_probe_model(data, bounds, words, cfg)
    got = np.asarray(bits)
    np.testing.assert_array_equal(got, want)
    assert int(total[0]) == int(
        np.unpackbits(want.view(np.uint8)).sum()
    )


def test_lane_tile_remainder_geometry():
    # 1200 lanes pad to 1280: the pad lanes must never survive and the
    # real lanes keep their columns
    cfg = make_cfg(q=4, stride=4, kbanks=2, v=1)
    rng = np.random.RandomState(2)
    words = rng.randint(-(2**31), 2**31, size=(2, 1, 128)).astype(np.int32)
    C, T = 1200, cfg.tile_rows
    data = rng.randint(0, 256, size=(C, T)).astype(np.uint8)
    bounds = np.stack(
        [np.zeros(C, np.int32), np.full(C, T, np.int32)]
    )
    total, bits = _hits_jit(data, bounds, words, cfg=cfg)
    want = np_probe_model(data, bounds, words, cfg)
    np.testing.assert_array_equal(np.asarray(bits), want)


def test_sampled_probe_matches_winnowing_model():
    # sampled mode: the probe's a+b >= w-1 selection against the
    # brute-force rightmost-argmin model, with planted pattern grams so
    # real survivors exist, ragged spans and an empty lane
    rng = np.random.RandomState(5)
    pats = [bytes(rng.randint(0, 256, size=10).astype(np.uint8))
            for _ in range(60)]
    for fold, force in ((False, ("sampled", 3, 4, 3, 2)),
                        (True, ("sampled", 4, 7, 2, 1))):
        bft = BloomFilterTable.build(pats, force=force, fold_case=fold)
        cfg = bft.cfg
        assert cfg.sampled and cfg.w == force[2]
        C, T = 130, 2 * cfg.tile_rows + 9
        data = rng.randint(0, 256, size=(C, T)).astype(np.uint8)
        for ln in range(0, C, 7):
            p = pats[ln % len(pats)]
            data[ln, 11 : 11 + len(p)] = np.frombuffer(p, np.uint8)
        bounds = np.stack([
            rng.randint(0, 9, size=C).astype(np.int32),
            rng.randint(T - 9, T + 1, size=C).astype(np.int32),
        ])
        bounds[1, 3] = bounds[0, 3]
        total, bits = _hits_jit(data, bounds, bft.words, cfg=cfg)
        want = np_sampled_model(data, bounds, bft.words, cfg)
        np.testing.assert_array_equal(np.asarray(bits), want)
        assert int(total[0]) == int(np.unpackbits(want.view(np.uint8)).sum())
        assert int(total[0]) > 0


def test_ushort_probe_matches_model():
    # alphabet-2048 signatures on uint16 lanes: the probe must match the
    # model bit for bit, and the exact verifier must find every planted
    # occurrence from its candidates
    from pattern_matching.core.dfa import AhoCorasick
    from pattern_matching.core.oracle import match_python
    from pattern_matching.ops.bloom import unpack_hit_rows
    from pattern_matching.runtime.verify import Verifier

    ac = AhoCorasick(alphabet_size=2048)
    sigs = [(40, 32, 287, 32, 106, 196), (1500, 1500, 40), (7, 7, 7, 7)]
    for sig in sigs:
        ac.add_pattern(sig)
    table = ac.compile()
    bft = BloomFilterTable.from_table(table)

    rng = np.random.RandomState(0)
    C, B, halo = 256, 512, 16
    data = rng.randint(0, 2048, size=(C, halo + B)).astype(np.uint16)
    plants = [(0, 100), (3, 500), (128, 5), (255, B - 10)]
    for i, (ln, pos) in enumerate(plants):
        sig = sigs[i % len(sigs)]
        data[ln, halo + pos : halo + pos + len(sig)] = sig
    start_t = np.full(C, halo, np.int32)
    end_t = np.full(C, halo + B, np.int32)
    bounds = np.stack([start_t, end_t])

    total, bits = _hits_jit(data, bounds, bft.words, cfg=bft.cfg)
    bits = np.asarray(bits)
    np.testing.assert_array_equal(
        bits, np_probe_model(data, bounds, bft.words, bft.cfg)
    )
    assert int(total[0]) > 0
    rows, lanes = unpack_hit_rows(bits, bft.cfg.stride)
    v = Verifier([p.symbols for p in table.patterns], alphabet_size=2048,
                 q=bft.cfg.q, max_pat_len=table.max_pat_len,
                 dense_table=table)
    got = sorted(set(v.verify_batch(data, lanes, rows, halo, start_t, end_t)))
    want = []
    for ln in range(C):
        for e, pid in match_python(
            [p.symbols for p in table.patterns], data[ln, halo:].tolist()
        ):
            want.append((ln, e + halo, pid))
    assert got == sorted(want)
    assert len(got) >= len(plants)


def test_compile_cache_honors_env(tmp_path, monkeypatch):
    import jax

    from pattern_matching.utils.common import enable_compile_cache

    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch):
    import os

    import jax

    from pattern_matching.utils.common import (
        DEFAULT_CACHE_DIR,
        enable_compile_cache,
    )

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = enable_compile_cache()
        assert path == DEFAULT_CACHE_DIR == os.path.join(root, ".jax_cache")
        assert enable_compile_cache() == path  # stable across calls
        with open(os.path.join(root, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
