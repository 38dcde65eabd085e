"""GPU hardware tests (skipped on the CPU mesh).

Run on a machine with an NVIDIA GPU: ``TPM_TEST_GPU=1 pytest -m gpu
tests/test_gpu_hardware.py``. Covers the device-compiled paths the CPU
suite cannot: the sampled probe, the byte order of the device-verify
bitcasts, the mesh steps and the refined ushort session, each compiled
by XLA for the card and checked against the oracle.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _needs_gpu():
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU (found {platform}; run with "
                    f"TPM_TEST_GPU=1 pytest -m gpu)")


def test_sampled_kernel_on_hardware():
    # the winnowing-sampled probe end-to-end on hardware
    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.core.oracle import match_python
    from pattern_matching.runtime.session import MatchSession

    rng = np.random.RandomState(4)
    pats = [bytes(rng.randint(0, 256, size=12).astype(np.uint8))
            for _ in range(256)]
    data = bytearray(rng.randint(0, 256, size=1 << 16).astype(np.uint8))
    for i, pos in enumerate((0, 5000, 65500)):
        p = pats[i]
        data[pos : pos + len(p)] = p
    data = bytes(data)
    sess = MatchSession(compile_patterns(pats), max_chunks=128,
                        chunk_len=512, engine="bloom",
                        bloom_opts={"mode": "sampled"})
    assert sess.find(data) == sorted(match_python(pats, data))

def test_bitcast_byte_order_and_device_verify_on_hardware():
    # the device-verify walk prefetches candidate windows as packed uint32
    # words (verify_device.py stage 3) and unpacks them assuming bitcast
    # element 0 = low byte; assert that order on the card, then run a
    # device-verify parity case through the compiled probe
    import jax
    import jax.numpy as jnp
    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.core.oracle import match_python
    from pattern_matching.runtime.session import MatchSession

    x = jnp.asarray(np.arange(8, dtype=np.uint8)).reshape(2, 4)
    w = np.asarray(jax.lax.bitcast_convert_type(x, jnp.uint32))
    assert list(w) == [0x03020100, 0x07060504]
    u = jnp.asarray(np.array([0x0102, 0x0304], np.uint16)).reshape(1, 2)
    assert int(np.asarray(
        jax.lax.bitcast_convert_type(u, jnp.uint32))[0]) == 0x03040102

    rng = np.random.RandomState(11)
    pats = [bytes(rng.randint(0, 256, size=rng.randint(5, 13)).astype(np.uint8))
            for _ in range(128)]
    data = bytearray(rng.randint(0, 256, size=1 << 15).astype(np.uint8))
    for i, pos in enumerate((1, 999, 32000)):
        p = pats[i]
        data[pos : pos + len(p)] = p
    data = bytes(data)
    sess = MatchSession(compile_patterns(pats), max_chunks=64,
                        chunk_len=512, engine="bloom", verify="device")
    assert sess.find(data) == sorted(match_python(pats, data))


def test_mesh_kernels_on_hardware():
    # the mesh steps — the shard_map bloom probe, MeshDeviceVerifier
    # events, and the all-device count step — must compile and run on
    # the card. A 1-device
    # mesh makes the collectives no-ops but the compiled SPMD shard_map
    # step and the device-verify walk are the real multi-chip code path.
    import io

    import jax

    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.core.oracle import match_python
    from pattern_matching.parallel.mesh import (
        MeshContext,
        make_mesh,
        make_sharded_bloom_count_step,
    )
    from pattern_matching.runtime.buffers import StreamState
    from pattern_matching.runtime.session import MatchSession

    ctx = MeshContext(make_mesh(jax.devices()[:1]))
    rng = np.random.RandomState(33)
    pats = [bytes(rng.randint(0, 256, size=rng.randint(5, 13)).astype(np.uint8))
            for _ in range(96)]
    data = bytearray(rng.randint(0, 256, size=1 << 15).astype(np.uint8))
    for i, pos in enumerate((3, 8000, 32000)):
        p = pats[i]
        data[pos : pos + len(p)] = p
    data = bytes(data)
    want = sorted(match_python(pats, data))
    want_pos = {off for off, _ in want}

    table = compile_patterns(pats)
    sess = MatchSession(table, max_chunks=128, chunk_len=512,
                        engine="bloom", mesh=ctx, verify="device")
    assert sess._dvf_mesh is not None
    assert sess.find(data) == want

    # the all-device count step (probe + device verify + psum group counts
    # in one jit) must agree with the event path
    step = make_sharded_bloom_count_step(
        ctx, sess._bloom, table, halo=sess.halo, k_cand=4096, k_ev=4096
    )
    buf = sess.new_buffer()
    buf.add_stream(io.BytesIO(data), StreamState(file_id=0))
    b = buf.to_batch()
    gcounts, n_ev, flags, _needs = step(
        sess._bloom.words,
        jax.device_put(
            np.ascontiguousarray(table.goto_signed).reshape(-1),
            ctx.replicated,
        ),
        jax.device_put(table.state_gid.astype(np.int32), ctx.replicated),
        jax.device_put(b.data, ctx.lane_sharded),
        jax.device_put(np.stack([b.start_t, b.end_t]), ctx.lane_sharded2d),
    )
    assert int(np.asarray(flags)) == 0
    assert int(np.asarray(n_ev)) == len(want_pos)
    assert int(np.asarray(gcounts).sum()) == len(want_pos)


def test_refined_ushort_session_on_hardware():
    # the compiled alphabet-2048 probe with the exact-gram
    # refinement stage fused in (11-bit key packing: straddles the 32-bit
    # lo/hi boundary at q >= 3) — refined find() must stay oracle-exact
    # on the card, and refinement must be attached
    import numpy as np

    from pattern_matching.core.dfa import AhoCorasick
    from pattern_matching.core.oracle import match_python
    from pattern_matching.runtime.session import MatchSession

    rng = np.random.RandomState(21)
    ac = AhoCorasick(alphabet_size=2048)
    pats = [tuple(int(x) for x in rng.randint(0, 2048,
                                              size=rng.randint(4, 9)))
            for _ in range(64)]
    for p in pats:
        ac.add_pattern(p)
    table = ac.compile()
    toks = rng.randint(0, 2048, size=4000).astype(np.uint16)
    for i, pos in enumerate((0, 1500, 3990)):
        p = pats[i]
        toks[pos : pos + len(p)] = p
    flow = ",".join(str(int(t)) for t in toks).encode()
    want = sorted(match_python([list(p) for p in pats], toks.tolist()))

    sess = MatchSession(table, max_chunks=16, chunk_len=256,
                        engine="bloom")
    if sess.bloom_table.cfg.q * 11 <= 64:
        assert sess._bloom.exact_meta is not None
    assert sess.find(flow) == want
    sessd = MatchSession(table, max_chunks=16, chunk_len=256,
                         engine="bloom", verify="device")
    assert sessd.find(flow) == want
