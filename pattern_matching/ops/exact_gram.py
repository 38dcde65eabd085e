"""Exact q-gram membership on device: the bloom engine's fp eraser.

The bloom probe's survivor set is (true gram occurrences) + (bloom false
positives); every downstream exactness stage — the host window walker
(runtime/verify.py) or the device windowed walk (ops/verify_device.py) —
pays ~0.7 us per candidate regardless of which kind it is. On random
input essentially ALL survivors are bloom fp (the true-gram rate is
n_grams / 256^q), so the pipelines burn their verify budget disproving
candidates a cheap exact check could have erased.

This module stores the builder's *exact inserted gram set* (the same set
the bloom words were built from — ops/bloom.py build()) in a linear-probe
hash table and tests compacted candidates against it with DMAX dependent
gathers per candidate.
A candidate whose gram is not literally in the inserted set can never
own a match (coverage guarantees every true occurrence contains an
inserted gram at a probed position — MATCHING.md; erasing non-members
only redistributes the ownership intervals among remaining candidates,
the same argument ops/verify_device.py makes for its keep intervals), so
refinement is exact: whenever q*bits <= 64 the packed key IS the gram
(8-bit symbols for the byte alphabet, 11-bit for the ushort/2048
variant) — zero residual false positives.

Cost: ~DMAX+q/4+1 gathers per candidate (~0.1 us) vs ~0.7 us for a
window walk — the walk then runs only on true gram occurrences, and the
chooser can buy shallower (faster) bloom filters because fp no longer
reaches the expensive stage (the refine-aware objective in
ops/bloom.py prices this).

The reference has no analogue: its hot kernel is exact in-kernel
(/root/reference/ahomatch.cl:63-74) and pays the serial DFA walk on
every byte instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_MASK32 = np.uint64(0xFFFFFFFF)
_MIX = np.uint32(0x2C1B3C6D)  # odd avalanche constant (host == device)


def _mix32_np(lo: np.ndarray, hi: np.ndarray, c1: np.uint32, c2: np.uint32):
    """Host model of the device slot hash (uint32 wrap arithmetic)."""
    h = (lo * c1 + hi * c2) & np.uint32(0xFFFFFFFF)
    h = h ^ (h >> np.uint32(15))
    h = (h * _MIX) & np.uint32(0xFFFFFFFF)
    return h ^ (h >> np.uint32(13))


def pack_grams(grams, q: int, bits: int = 8) -> np.ndarray:
    """Gram tuples -> sorted unique uint64 keys, symbol i at bit ``bits*i``.

    ``bits`` is the symbol width: 8 for the byte alphabet, 11 for the
    ushort (alphabet-2048) variant. q*bits <= 64 symbols fit one uint64
    key, so key equality IS gram equality — the exactness of the whole
    scheme rests on this line."""
    if q * bits > 64:
        raise ValueError(
            f"exact gram table needs q*bits <= 64, got q={q} bits={bits}"
        )
    if not grams:
        return np.zeros(0, np.uint64)
    arr = np.asarray(sorted(grams), np.uint64).reshape(-1, q)
    if arr.max() >> np.uint64(bits):
        raise ValueError(f"gram symbol out of range for {bits}-bit packing")
    key = np.zeros(len(arr), np.uint64)
    for i in range(q):
        key |= arr[:, i] << np.uint64(bits * i)
    return np.unique(key)


@dataclasses.dataclass
class ExactGramTable:
    """Linear-probe table over the inserted gram keys.

    ``lo``/``hi`` are [M + dmax] uint32 planes (hi is all-zero and unused
    by the device check when q <= 4). Empty slots hold the FIRST key's
    value — safe: a non-member probe key never equals any member value,
    and a member never probes an empty slot (it found its own within
    dmax by construction)."""

    lo: np.ndarray  # [M + dmax] uint32
    hi: np.ndarray  # [M + dmax] uint32
    q: int
    dmax: int
    m: int  # power-of-two slot count (mask = m - 1)
    c1: int  # per-build hash constants (reseeded until placement fits)
    c2: int
    n: int  # member count
    bits: int = 8  # symbol width (8 = byte alphabet, 11 = ushort/2048)

    @property
    def use_hi(self) -> bool:
        return self.q * self.bits > 32

    def device_meta(self, fold_case: bool) -> tuple:
        """The static lookup-parameter tuple every traced consumer takes
        (bloom._hits_refined_jit, verify_device._verify_kernel, the mesh
        and pshard count steps) — one constructor so the layout has one
        owner."""
        return (
            self.dmax, self.m, self.c1, self.c2, self.n,
            bool(fold_case), self.use_hi, self.bits,
        )


def build_exact_table(
    grams, q: int, seed: int = 0, bits: int = 8
) -> ExactGramTable:
    """Build from gram tuples (packs, then places)."""
    return table_from_keys(pack_grams(grams, q, bits), q, seed, bits)


_DMAX = 4


def _try_place(
    keys: np.ndarray, m: int, c1: np.uint32, c2: np.uint32,
    dmax: int = _DMAX,
) -> np.ndarray | None:
    """Greedy vectorized linear-probe placement: per distance d, every
    unplaced key bids for slot h+d; one winner per slot (np.unique
    first-occurrence), losers re-bid at d+1. Returns the slot array or
    None when some key cannot place within ``dmax``."""
    n = len(keys)
    lo_all = (keys & _MASK32).astype(np.uint32)
    hi_all = (keys >> np.uint64(32)).astype(np.uint32)
    h = (_mix32_np(lo_all, hi_all, c1, c2) & np.uint32(m - 1)).astype(
        np.int64
    )
    slot = np.full(n, -1, np.int64)
    taken = np.zeros(m + dmax, bool)
    pending = np.arange(n)
    for d in range(dmax):
        bid = h[pending] + d
        free = ~taken[bid]
        cand = pending[free]
        bid = bid[free]
        uniq, first = np.unique(bid, return_index=True)
        slot[cand[first]] = uniq
        taken[uniq] = True
        pending = pending[~np.isin(pending, cand[first])]
        if not len(pending):
            return slot
    return None


def _fill_table(
    keys: np.ndarray, slot: np.ndarray, q, dmax, m, c1, c2, bits
) -> ExactGramTable:
    lo_all = (keys & _MASK32).astype(np.uint32)
    hi_all = (keys >> np.uint64(32)).astype(np.uint32)
    # empty slots hold the FIRST key's value (safe, see class docstring)
    lo = np.full(m + dmax, lo_all[0], np.uint32)
    hi = np.full(m + dmax, hi_all[0], np.uint32)
    lo[slot] = lo_all
    hi[slot] = hi_all
    return ExactGramTable(
        lo=lo, hi=hi, q=q, dmax=dmax, m=m,
        c1=int(c1), c2=int(c2), n=len(keys), bits=bits,
    )


def table_from_keys(
    keys: np.ndarray, q: int, seed: int = 0, bits: int = 8
) -> ExactGramTable:
    """Place every key within ``dmax`` linear-probe slots of its hash.

    ``keys``: packed uint64 gram keys (pack_grams layout, e.g. the
    persisted BloomFilterTable.gram_keys). If any key is left unplaced
    after dmax greedy rounds, reseed the hash; after a few seeds, double
    the table. Load factor starts at <= 0.5 so placement virtually always
    succeeds on the first try."""
    return tables_from_keys_common([keys], q, seed, bits)[0]


def tables_from_keys_common(
    keys_list, q: int, seed: int = 0, bits: int = 8
) -> list[ExactGramTable]:
    """Build one table per key set, all sharing (m, dmax, c1, c2).

    The pattern-sharded mesh step walks each shard's table under
    shard_map, where the lookup parameters are STATIC (one compiled
    kernel) and only the [S, m+dmax] planes shard over the "pat" axis —
    so every shard's placement must succeed with the same constants."""
    keys_list = [np.unique(np.asarray(k, np.uint64)) for k in keys_list]
    m0 = 128
    for k in keys_list:
        while m0 < 2 * len(k):
            m0 *= 2
    rng = np.random.RandomState(seed ^ 0xE9AC7)
    # prefer dmax=2 at load <= 0.25 (the per-candidate device check costs
    # dmax gathers — the refinement's hot marginal); fall back to the
    # denser dmax=4 layout, then grow the table
    attempts = [(2, m0 * 2), (4, m0), (2, m0 * 4), (4, m0 * 2)]
    while True:
        for dmax, m in attempts:
            for _try in range(8):
                c1 = np.uint32(int(rng.randint(1, 2**31)) | 1)
                c2 = np.uint32(int(rng.randint(1, 2**31)) | 1)
                slots = []
                for k in keys_list:
                    if len(k) == 0:
                        slots.append(np.zeros(0, np.int64))
                        continue
                    s = _try_place(k, m, c1, c2, dmax)
                    if s is None:
                        break
                    slots.append(s)
                if len(slots) == len(keys_list):
                    out = []
                    for k, s in zip(keys_list, slots):
                        if len(k) == 0:
                            out.append(ExactGramTable(
                                lo=np.zeros(m + dmax, np.uint32),
                                hi=np.zeros(m + dmax, np.uint32),
                                q=q, dmax=dmax, m=m,
                                c1=int(c1), c2=int(c2), n=0, bits=bits,
                            ))
                        else:
                            out.append(
                                _fill_table(k, s, q, dmax, m, c1, c2, bits)
                            )
                    return out
        attempts = [(d, m * 2) for d, m in attempts]


def member_mask_np(table: ExactGramTable, keys: np.ndarray) -> np.ndarray:
    """Host-side membership (tests + host-path mirrors)."""
    lo = (keys & _MASK32).astype(np.uint32)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    h = (
        _mix32_np(lo, hi, np.uint32(table.c1), np.uint32(table.c2))
        & np.uint32(table.m - 1)
    ).astype(np.int64)
    ok = np.zeros(len(keys), bool)
    for d in range(table.dmax):
        hit = table.lo[h + d] == lo
        if table.use_hi:
            hit &= table.hi[h + d] == hi
        ok |= hit
    if table.n == 0:
        ok[:] = False
    return ok


# --------------------------------------------------------------------------
# device side
# --------------------------------------------------------------------------


@dataclasses.dataclass
class DeviceExact:
    """Device-resident planes + static lookup parameters."""

    lo: object  # jax [M + dmax] int32
    hi: object | None  # jax [M + dmax] int32, None when q*bits <= 32
    q: int
    dmax: int
    m: int
    c1: int
    c2: int
    n: int
    fold_case: bool
    bits: int = 8  # symbol width (pack_grams layout)

    @staticmethod
    def put(table: ExactGramTable, fold_case: bool, sharding=None):
        import jax

        put = (
            (lambda x: jax.device_put(x, sharding))
            if sharding is not None
            else jax.device_put
        )
        return DeviceExact(
            lo=put(table.lo.view(np.int32)),
            hi=put(table.hi.view(np.int32)) if table.use_hi else None,
            q=table.q,
            dmax=table.dmax,
            m=table.m,
            c1=table.c1,
            c2=table.c2,
            n=table.n,
            fold_case=fold_case,
            bits=table.bits,
        )

    @staticmethod
    def from_meta(lo, hi, q: int, fold_case_allowed: bool, meta: tuple):
        """Rehydrate from the static ``ExactGramTable.device_meta`` tuple
        (the form traced consumers receive)."""
        dmax, m, c1, c2, n, fold, use_hi, bits = meta
        return DeviceExact(
            lo=lo, hi=hi if use_hi else None, q=q, dmax=dmax, m=m,
            c1=c1, c2=c2, n=n,
            fold_case=fold and fold_case_allowed, bits=bits,
        )


def exact_member(dx: DeviceExact, data_flat, base, valid):
    """Traced membership check: is data[base : base + q] an inserted gram?

    ``data_flat``: [C*T] symbols (uint8/int32-safe values); ``base``: [K]
    int32 flat gram start positions; ``valid``: [K] bool (sentinel slots
    — compaction padding — come back False).

    q per-symbol gathers + dmax (or 2*dmax for q > 4) table gathers per
    candidate; every other op is elementwise. Called inside larger jits (the verify kernel,
    the refined probe)."""
    import jax
    import jax.numpy as jnp

    K = base.shape[0]
    size = data_flat.shape[0]
    if dx.n == 0:
        return jnp.zeros((K,), jnp.bool_)
    lo = jnp.zeros((K,), jnp.int32)
    hi = jnp.zeros((K,), jnp.int32)
    for i in range(dx.q):
        s = jnp.take(
            data_flat, jnp.clip(base + i, 0, size - 1), mode="clip"
        ).astype(jnp.int32)
        if dx.fold_case:
            s = jnp.where((s >= 65) & (s <= 90), s + 32, s)
        # place symbol i at key bit bits*i; the pack_grams uint64 layout
        # splits into (lo, hi) 32-bit planes, so a symbol straddling bit
        # 32 contributes its low part to lo (the high bits fall off the
        # int32 shift — intended) and its high part to hi
        bp = dx.bits * i
        if bp + dx.bits <= 32:
            lo = lo | jax.lax.shift_left(s, jnp.int32(bp))
        elif bp >= 32:
            hi = hi | jax.lax.shift_left(s, jnp.int32(bp - 32))
        else:
            lo = lo | jax.lax.shift_left(s, jnp.int32(bp))
            hi = hi | jax.lax.shift_right_logical(s, jnp.int32(32 - bp))
    h = lo * jnp.int32(np.int32(np.uint32(dx.c1))) + hi * jnp.int32(
        np.int32(np.uint32(dx.c2))
    )
    h = h ^ jax.lax.shift_right_logical(h, 15)
    h = h * jnp.int32(np.int32(_MIX))
    h = h ^ jax.lax.shift_right_logical(h, 13)
    h = h & jnp.int32(dx.m - 1)
    ok = jnp.zeros((K,), jnp.bool_)
    for d in range(dx.dmax):
        hit = jnp.take(dx.lo, h + d, mode="clip") == lo
        if dx.hi is not None:
            hit = hit & (jnp.take(dx.hi, h + d, mode="clip") == hi)
        ok = ok | hit
    return ok & valid
