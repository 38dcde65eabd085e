"""Exact-gram membership: host model == device check == brute force."""

import numpy as np
import pytest

from pattern_matching.ops.exact_gram import (
    DeviceExact,
    build_exact_table,
    exact_member,
    member_mask_np,
    pack_grams,
)


def _rand_grams(rng, n, q, alpha=256):
    return {
        tuple(int(x) for x in rng.randint(0, alpha, q)) for _ in range(n)
    }


@pytest.mark.parametrize("q", [1, 2, 3, 4, 5, 6, 8])
def test_membership_brute_force(q):
    rng = np.random.RandomState(q)
    grams = _rand_grams(rng, 500, q)
    t = build_exact_table(grams, q)
    assert t.n == len(pack_grams(grams, q))
    # every member found
    keys = pack_grams(grams, q)
    assert member_mask_np(t, keys).all()
    # random non-members rejected (draw fresh, exclude members)
    probe = pack_grams(_rand_grams(rng, 2000, q), q)
    probe_in = np.isin(probe, keys)
    got = member_mask_np(t, probe)
    np.testing.assert_array_equal(got, probe_in)


def test_empty_and_tiny():
    t = build_exact_table(set(), 4)
    assert t.n == 0
    assert not member_mask_np(t, np.asarray([0, 123456], np.uint64)).any()
    t1 = build_exact_table({(7, 8, 9, 10)}, 4)
    k = pack_grams({(7, 8, 9, 10)}, 4)
    assert member_mask_np(t1, k).all()
    assert not member_mask_np(t1, k + np.uint64(1)).any()


def test_device_check_matches_host():
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    q = 4
    data = rng.randint(0, 256, 4096).astype(np.uint8)
    # half the grams come from the data (members that WILL be probed)
    grams = {
        tuple(int(x) for x in data[o : o + q]) for o in range(0, 2000, 7)
    }
    grams |= _rand_grams(rng, 300, q)
    t = build_exact_table(grams, q)
    dx = DeviceExact.put(t, fold_case=False)
    base = np.arange(0, len(data) - q, 3, dtype=np.int32)
    valid = np.ones(len(base), bool)
    got = np.asarray(
        exact_member(dx, jnp.asarray(data), jnp.asarray(base),
                     jnp.asarray(valid))
    )
    expect = np.array(
        [tuple(int(x) for x in data[b : b + q]) in grams for b in base]
    )
    np.testing.assert_array_equal(got, expect)


def test_device_check_q6_and_fold_case():
    import jax.numpy as jnp

    rng = np.random.RandomState(5)
    q = 6
    data = np.frombuffer(b"Hello World HELLO hello xyzzyx" * 20, np.uint8)
    folded = np.where((data >= 65) & (data <= 90), data + 32, data)
    grams = {tuple(int(x) for x in folded[o : o + q]) for o in range(0, 60)}
    grams |= _rand_grams(rng, 100, q)
    t = build_exact_table(grams, q)
    dx = DeviceExact.put(t, fold_case=True)
    base = np.arange(0, len(data) - q, 2, dtype=np.int32)
    got = np.asarray(
        exact_member(
            dx, jnp.asarray(data), jnp.asarray(base),
            jnp.ones(len(base), bool),
        )
    )
    expect = np.array(
        [tuple(int(x) for x in folded[b : b + q]) in grams for b in base]
    )
    np.testing.assert_array_equal(got, expect)


def test_invalid_slots_rejected():
    import jax.numpy as jnp

    t = build_exact_table({(1, 2, 3, 4)}, 4)
    dx = DeviceExact.put(t, fold_case=False)
    data = np.asarray([1, 2, 3, 4], np.uint8)
    base = np.asarray([0, 0], np.int32)
    valid = np.asarray([True, False])
    got = np.asarray(
        exact_member(dx, jnp.asarray(data), jnp.asarray(base),
                     jnp.asarray(valid))
    )
    assert got.tolist() == [True, False]


def test_dense_load_placement():
    # force high load / collisions: tiny value space
    rng = np.random.RandomState(9)
    grams = _rand_grams(rng, 5000, 2)  # <= 65536 possible values
    t = build_exact_table(grams, 2)
    keys = pack_grams(grams, 2)
    assert member_mask_np(t, keys).all()
    uni = np.arange(65536, dtype=np.uint64)
    got = member_mask_np(t, uni)
    np.testing.assert_array_equal(got, np.isin(uni, keys))


@pytest.mark.parametrize("q", [1, 2, 3, 4, 5])
def test_membership_brute_force_ushort(q):
    # 11-bit symbol packing (the alphabet-2048 ushort variant): key
    # equality must still be gram equality, including symbols straddling
    # the 32-bit lo/hi boundary (q=3: bit 33; q=4: bit 44; q=5: bit 55)
    rng = np.random.RandomState(40 + q)
    grams = _rand_grams(rng, 500, q, alpha=2048)
    t = build_exact_table(grams, q, bits=11)
    keys = pack_grams(grams, q, bits=11)
    assert t.n == len(keys) and t.bits == 11
    assert member_mask_np(t, keys).all()
    probe = pack_grams(_rand_grams(rng, 2000, q, alpha=2048), q, bits=11)
    np.testing.assert_array_equal(
        member_mask_np(t, probe), np.isin(probe, keys)
    )


@pytest.mark.parametrize("q", [2, 3, 4, 5])
def test_device_check_matches_host_ushort(q):
    # the device lo/hi packing (static shifts with 32-bit straddle) must
    # agree with the host uint64 packing for 11-bit symbols
    import jax.numpy as jnp

    rng = np.random.RandomState(50 + q)
    data = rng.randint(0, 2048, 4096).astype(np.uint16)
    grams = {
        tuple(int(x) for x in data[o : o + q]) for o in range(0, 2000, 7)
    }
    grams |= _rand_grams(rng, 300, q, alpha=2048)
    t = build_exact_table(grams, q, bits=11)
    dx = DeviceExact.put(t, fold_case=False)
    base = np.arange(0, len(data) - q, 3, dtype=np.int32)
    got = np.asarray(
        exact_member(dx, jnp.asarray(data), jnp.asarray(base),
                     jnp.ones(len(base), bool))
    )
    expect = np.array(
        [tuple(int(x) for x in data[b : b + q]) in grams for b in base]
    )
    np.testing.assert_array_equal(got, expect)


def test_pack_grams_rejects_overflow():
    with pytest.raises(ValueError):
        pack_grams({(1, 2, 3, 4, 5, 6)}, 6, bits=11)  # 66 > 64 bits
    with pytest.raises(ValueError):
        pack_grams({(2048,)}, 1, bits=11)  # symbol out of range
