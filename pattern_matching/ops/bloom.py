"""q-gram bloom-filter scan engine.

Multi-pattern matching restructured as filter + exact verify:

1. **Filter (device, plain XLA)**: hash the q-symbol window at every
   tested position of every lane and probe k independent blocked bloom
   banks. Each bank is V "units" of 128 int32 words = 4096 bits; hash bits
   select the unit, the word and the bit, and one gather from the flat
   word array reads it. A position survives only if ALL k banks hit; the
   false-positive rate is the product of the banks' bit densities
   (computed exactly at build time).
2. **Pack (device)**: survivor rows are masked against lane bounds and
   bit-packed, so the device->host result is a complete bitmap 32*stride
   times smaller than the input (no capacity cap, no overflow mode), plus
   a popcount total fetched first (zero-match batches cost one 4-byte
   transfer, mirroring the dense engine's 2-transfer decode).
3. **Verify (host or device)**: candidates expand to windows, merge per
   lane, and are scanned by the native C++ Aho-Corasick walker
   (``core/oracle_native``) or on device (``ops/verify_device.py``) for
   exact ``(end_offset, pattern_set)`` events. False positives die here;
   every true match is provably covered (below).

Coverage guarantee: grams are inserted at offsets 0..s-1 of every pattern
(strided mode). An occurrence of a pattern with length L >= s+q-1 spans gram
positions g0..g0+L-q; any s consecutive integers contain a multiple of s, so
some tested position t* (tested <=> t* % s == 0) falls in [g0, g0+s-1], and
the input gram there equals the pattern's gram at offset t*-g0 <= s-1 —
which is in the bloom. q = floor((Lmin+1)/2) <= s, so a gram window never
crosses a stride group.
The builder searches (q, stride, kbanks, v) jointly: stride trades probe
cost per byte against bloom load (stride grams per pattern), and the score
includes the TRUE-gram hit rate — a filter on 1-grams of a 10k-pattern set
would pass every byte no matter how empty the bloom is.

This replaces the role of ahomatch.cl:50-77 (the per-byte DFA walk): the
device does a fixed amount of hashing per tested position instead of a
data-dependent table walk per byte.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

MASK32 = 0xFFFFFFFF
REFINE_HEADROOM = 2.0  # k_ref capacity = headroom x modeled candidate rate
# x batch positions (runtime/session.py). The refinement stage's cost is
# linear in the CAPACITY bucket, so headroom is a real per-batch tax;
# overflow is graceful (the unrefined bitmap passes through and the host
# absorbs it), so modest headroom + the {1,1.5}x2^k next_cap ladder is the
# right trade.
GT = 64  # tested rows per padding tile; a multiple of 32 (one bitmap word)
L1_FILTER_BYTES = 128 * 1024  # larger filters are served from L2


def probe_cost_units(q: int, k: int, v: int, *, s: int = 1, w: int = 0
                     ) -> float:
    """Model element-ops per input byte for a probe config — the chooser's
    probe-cost currency, and the unit the calibrator (ops/costmodel.py)
    prices in ns on the attached device.

    Per tested position: hashing (2.5 ops/symbol for two multiply-adds),
    then per bank ~6 ops of index math plus one gather (priced as 4 ops)
    and the bit test. Strided mode amortizes over the stride; sampled mode
    hashes every position and pays ~3 ops per window step for the
    winnowing compares. A filter larger than L1_FILTER_BYTES (k*v*512 B)
    serves its gathers from L2 instead of L1, priced at 1.5x (a model,
    not yet measured on the card)."""
    per_pos = 2.5 * q + k * 10.0
    c = per_pos + 3.0 * w if w else per_pos / s
    return c * 1.5 if k * v * 512 > L1_FILTER_BYTES else c


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    """Static shape/hash parameters (hashable: used as a jit static arg).

    Two sampling modes select which gram positions are tested:

    - **strided** (``sampled=False``): positions at multiples of ``stride``;
      grams inserted at pattern offsets 0..stride-1 (bloom load =
      stride x patterns).
    - **sampled/winnowing** (``sampled=True``): every position is hashed;
      a position is tested iff it is the rightmost-argmin of some
      ``w``-window of the selection hash (Schleimer et al. winnowing).
      The builder inserts only each pattern's per-window rightargmin grams
      (~1 gram/pattern when pattern length ~= lmin), cutting bloom load
      ~stride-fold — the enabler for 100k+ pattern sets, where strided
      mode's bloom capacity (k*v gather chains) is the wall.
    """

    q: int  # gram length (symbols)
    stride: int  # tested-position stride; q <= stride (strided mode; 1 when sampled)
    kbanks: int  # independent bloom banks (ALL must hit)
    v: int  # 4096-bit units per bank
    mix1: tuple[int, ...]  # per-symbol odd multipliers, hash 1
    mix2: tuple[int, ...]  # per-symbol odd multipliers, hash 2
    fold_case: bool = False  # ASCII-fold input symbols before hashing
    sampled: bool = False  # winnowing selection instead of strided
    w: int = 0  # winnowing window (gram positions); w <= lmin - q + 1

    @property
    def bits(self) -> int:
        return self.kbanks * self.v * 4096

    @property
    def tile_rows(self) -> int:
        return GT * self.stride


def _hash_fields_np(m1, m2, b, v):
    """Host model of the device hash (uint64 arrays masked to 32 bits)."""
    h = (m1 + b * m2) & MASK32
    h = h ^ (h >> np.uint64(13))
    vi = (h >> np.uint64(17)) & np.uint64(v - 1)
    w7 = (h >> np.uint64(10)) & np.uint64(127)
    bit = (h >> np.uint64(5)) & np.uint64(31)
    return vi, w7, bit


def _grams_of(symbols: Sequence[int], q: int, offsets) -> list[tuple]:
    s = list(symbols)
    return [tuple(s[o : o + q]) for o in offsets if o + q <= len(s)]


def _sel_hash_np(m1: np.ndarray) -> np.ndarray:
    """Host model of the device selection hash (31-bit, so INT32_MAX can
    serve as the out-of-bounds sentinel on device)."""
    h = (m1 ^ (m1 >> np.uint64(13))) & np.uint64(MASK32)
    return h & np.uint64(0x7FFFFFFF)


def _gram_m1(symbols: Sequence[int], q: int, mix1) -> np.ndarray:
    """m1 hash of every gram of one pattern (uint64 array, 32-bit wrapped)."""
    s = np.asarray(list(symbols), np.uint64)
    m = len(s) - q + 1
    if m <= 0:
        return np.zeros(0, np.uint64)
    out = np.zeros(m, np.uint64)
    for i in range(q):
        out = (out + s[i : i + m] * np.uint64(mix1[i])) & np.uint64(MASK32)
    return out


def _winnow_offsets(h: np.ndarray, w: int) -> list[int]:
    """Gram offsets selected by winnowing: the rightmost-argmin of every
    w-window (Schleimer et al.; rightmost tie rule matches the device's
    a+b >= w-1 characterization in the sampled kernel)."""
    m = len(h)
    sel = set()
    for u in range(0, m - w + 1):
        win = h[u : u + w]
        sel.add(u + (w - 1 - int(np.argmin(win[::-1]))))
    return sorted(sel)


def _winnow_grams(pats: list[list[int]], q: int, w: int, mix1) -> set:
    """Winnowing fingerprint gram set over a whole pattern list,
    vectorized per length group (the per-pattern Python loop is minutes at
    100k patterns; this is milliseconds)."""
    from numpy.lib.stride_tricks import sliding_window_view

    by_len: dict[int, list[list[int]]] = {}
    for p in pats:
        by_len.setdefault(len(p), []).append(p)
    mix = np.asarray(mix1[:q], np.uint64)
    grams: set = set()
    for L, group in by_len.items():
        arr = np.asarray(group, np.uint64)  # [N, L]
        M = L - q + 1
        if M < w:
            # coverage needs a full w-window of gram positions inside
            # every pattern (w <= Lmin - q + 1, enforced by the chooser)
            raise ValueError(f"pattern length {L} too short for q={q} w={w}")
        m1 = np.zeros((len(group), M), np.uint64)
        for i in range(q):
            m1 = (m1 + arr[:, i : i + M] * mix[i]) & np.uint64(MASK32)
        h = _sel_hash_np(m1)  # [N, M]
        win = sliding_window_view(h, w, axis=1)  # [N, M-w+1, w]
        # rightmost argmin = (w-1) - argmin of the reversed window
        ridx = (w - 1) - np.argmin(win[:, :, ::-1], axis=2)  # [N, M-w+1]
        offs = ridx + np.arange(M - w + 1)[None, :]
        barr = arr.astype(np.uint16)
        for r in range(len(group)):
            row = barr[r]
            for o in set(offs[r].tolist()):
                grams.add(tuple(int(x) for x in row[o : o + q]))
    return grams


@dataclasses.dataclass
class BloomFilterTable:
    """Host-side compiled filter: bloom words + config + diagnostics."""

    words: np.ndarray  # [kbanks, v, 128] int32 (bit-packed)
    cfg: BloomConfig
    max_pat_len: int
    n_grams: int
    fp_est: float  # expected false-positive rate per tested position
    gram_keys: np.ndarray | None = None  # sorted uint64 packed gram keys
    # (the EXACT inserted set, ops/exact_gram.pack_grams layout at
    # ``gram_bits`` per symbol) — feeds the exact-membership refinement
    # stage; None when q*bits > 64 or for loads of pre-refinement dumps
    # (refinement silently unavailable)
    alphabet_size: int = 256  # symbol universe (2048 for the ushort mode)

    @property
    def gram_bits(self) -> int:
        """Symbol width of the gram_keys packing (8 byte / 11 ushort)."""
        return (self.alphabet_size - 1).bit_length()

    @staticmethod
    def from_table(table, **kw) -> "BloomFilterTable":
        """Build from a compiled :class:`core.dfa.DfaTable` (byte or ushort
        alphabet; byte patterns are already case-folded when
        table.nocase)."""
        return BloomFilterTable.build(
            [p.symbols for p in table.patterns],
            alphabet_size=table.alphabet_size,
            fold_case=getattr(table, "nocase", False),
            **kw,
        )

    @staticmethod
    def build(
        patterns: Sequence[Sequence[int] | bytes],
        fp_target: float = 1e-3,
        max_v: int = 16,
        max_k: int = 16,
        max_stride: int = 16,
        seed: int = 0x5EED,
        fold_case: bool = False,
        alphabet_size: int = 256,
        mode: str = "auto",
        force: tuple | None = None,  # ("strided", q, s, k, v) or
        # ("sampled", q, w, k, v): bypass the chooser (A/B experiments
        # validating the cost model, exp_verify_ab.py)
        objective: str = "refined",
        verify_ns_per_cand: float | None = None,  # host verify cost per
        # candidate, incl. bitmap unpack + window merge; None reads the
        # calibrated constants (ops/costmodel.get_cost_constants)
        rate_scale: float = 1.0,  # candidate-rate multiplier for verify
        # pricing and eligibility: the sharded build (parallel/pshard.py)
        # passes S, because the verifier walks the UNION of S shard
        # bitmaps — per-shard fp sums over shards while probe cost per
        # CHIP stays per-shard on a ("pat","data") mesh. Without this the
        # probe objective's cap admits configs whose union candidate
        # flood no verifier absorbs
    ) -> "BloomFilterTable":
        """Compile the filter, choosing (mode, q, stride/w, kbanks, v).

        Two sampling modes compete in the search (``mode="auto"``; force
        with "strided"/"sampled"):

        **strided** — coverage needs grams at pattern offsets 0..stride-1
        for ANY stride <= Lmin-q+1; the kernel's window trick needs
        q <= stride. Larger stride costs fewer probes per byte but loads
        the bloom with stride grams per pattern (worse fp).

        **sampled (winnowing)** — every position hashes, a position is
        tested iff it is the rightmost-argmin of some w-window; the bloom
        holds only each pattern's per-window rightargmin grams (~1 per
        pattern at L ~= Lmin). ~stride-x more probe work per byte, but
        bloom load drops ~stride-fold — for pattern sets past tens of
        thousands, where strided mode's stride grams per pattern saturate
        the filter, this is the way to keep the candidate rate down.

        ``objective`` picks what the search minimizes:

        - "refined" (default) — the PIPELINED per-byte cost of the
          pipeline sessions actually run: the device pays probe +
          on-device exact-gram refinement (fixed top_k + a headroom-scaled
          per-slot marginal), the host pays only the true-gram residue.
          A config whose grams cannot pack into one uint64 key
          (q*bits > 64 — never hit by byte alphabets, q > 5 for the
          ushort/2048 alphabet) runs unrefined, so it is priced with the
          "joint" formula instead. Constants come from
          ops/costmodel.calibrate() on the attached device.
        - "joint" — max(probe_ns, rate x verify_ns_per_cand): the
          UNREFINED host-verify pipeline (probe and host verify overlap in
          scan_stream, the slower stage is the throughput). The peak
          single-chip mode when a spare host core exists and the bitmap
          D2H is cheap.
        - "probe" — legacy probe-cost objective with a soft verify
          surcharge (the round-2 rule; kept for probe-only benchmarking
          continuity, bench.py primary metric).

        If no config meets the eligibility rate cap, the lowest-rate one
        wins — correctness never depends on fp, only verify cost does.
        """
        if fold_case and alphabet_size != 256:
            raise ValueError("fold_case requires the byte alphabet")
        if mode not in ("auto", "strided", "sampled"):
            raise ValueError(f"unknown mode {mode!r}")
        pats = [list(p) for p in patterns]
        if not pats:
            raise ValueError("no patterns")
        sym_bits = (alphabet_size - 1).bit_length()
        lmin = min(len(p) for p in pats)
        lmax = max(len(p) for p in pats)
        q_max = max(1, min(6, (lmin + 1) // 2))

        rng = np.random.RandomState(seed)
        # fixed-size draw (q never exceeds 8): the mix streams must not
        # depend on lmin, so pattern SUBSETS built with the same seed get
        # identical mixes — the sharded build (parallel/pshard.py) relies
        # on one config probing every shard's filter
        mix1_full = tuple(int(x) | 1 for x in rng.randint(1, 2**31, size=8))
        mix2_full = tuple(int(x) | 1 for x in rng.randint(1, 2**31, size=8))

        def n_est(q, s):
            return sum(min(s, len(p) - q + 1) for p in pats)

        _fingerprints: dict[tuple[int, int], int] = {}

        def n_sampled(q, w):
            # exact winnowing fingerprint count (the real insertion set)
            if (q, w) not in _fingerprints:
                _fingerprints[(q, w)] = len(
                    _winnow_grams(pats, q, w, mix1_full)
                )
            return _fingerprints[(q, w)]

        def candidate_rate(q, n, k, v, *, s=1, w=0):
            # expected candidates per input byte on uniform data: true gram
            # occurrences (the filter cannot reject a gram that IS in the
            # set — this is what kills tiny q for large sets) + bloom fp.
            # Strided: amortized over the stride. Sampled: only selected
            # positions (density ~2/(w+1)) can become candidates.
            universe = float(alphabet_size) ** q
            distinct = universe * -np.expm1(-n / universe)
            true_rate = distinct / universe
            fp = float((1.0 - np.exp(-n / (v * 4096.0))) ** k)
            if w:
                return (min(1.0, true_rate) + fp) * 2.0 / (w + 1)
            return (min(1.0, true_rate) + fp) / s

        def true_rate_of(q, n, *, s=1, w=0):
            # the component of candidate_rate the exact-gram refinement
            # CANNOT erase: grams literally in the inserted set
            universe = float(alphabet_size) ** q
            tr = min(1.0, universe * -np.expm1(-n / universe) / universe)
            return tr * 2.0 / (w + 1) if w else tr / s

        probe_cost = probe_cost_units

        best = None  # (objective, q, s, w, k, v) meeting the rate cap
        fallback = None  # (rate, cost, q, s, w, k, v) best-effort

        # Priced hardware (ops/costmodel.py): env/cache-file calibration
        # with the shipped calibrated defaults as fallback. The meanings:
        # PROBE_NS_PER_UNIT — ns/byte per probe_cost_units unit.
        # Exact-gram refinement pricing (objective="refined"): the
        # refinement runs ON DEVICE in the probe's jit, so its cost adds
        # to the device side while the host sees only true-gram
        # candidates: a fixed stage-1 top_k term per byte (1/stride the
        # words on strided bitmaps) + a per-CAPACITY-SLOT marginal
        # (stage-2 compaction + q gram gathers + dmax exact probes +
        # scatter-back, all linear in k_ref). Slots are sized
        # REFINE_HEADROOM x modeled rate (runtime/session.py uses the
        # same constant), so the per-candidate price is headroom-scaled.
        # VERIFY_NS_PER_CAND — host native-walker cost per candidate.
        from pattern_matching.ops.costmodel import get_cost_constants

        _cc = get_cost_constants(alphabet_size)
        PROBE_NS_PER_UNIT = _cc.probe_ns_per_unit
        REFINE_NS_PER_SLOT = _cc.refine_ns_per_slot
        REFINE_FIXED_NS_PER_BYTE = _cc.refine_fixed_ns_per_byte
        if verify_ns_per_cand is None:
            verify_ns_per_cand = _cc.verify_ns_per_cand

        # Legacy probe-objective surcharge (round-2 rule, kept for
        # objective="probe"): a soft verify tax + throughput-coupled cap.
        VERIFY_UNITS = 1800.0

        # a config can run refined iff its grams pack into one uint64 key
        # (ops/exact_gram.pack_grams): q*bits <= 64 — always true for byte
        # alphabets at q <= 8, and for the ushort alphabet at q <= 5
        def refinable(q):
            return q * sym_bits <= 64

        def rate_cap(cost):
            if objective == "refined":
                # the device-side refine stage absorbs floods the host
                # never sees; cap only what the compaction capacity
                # (k_ref <= MAX_DEVICE_CAND per ~16 MiB batch) can hold
                return max(fp_target, 5e-3)
            if objective == "joint":
                # eligibility only guards against candidate floods the
                # decode path cannot absorb; the objective itself prices
                # verify correctly
                return max(fp_target, 1e-2)
            return max(fp_target, min(4e-3, 2e-5 * cost))

        def consider(rate, true_rate, cost, q, s, w, k, v):
            nonlocal best, fallback
            rate = rate * rate_scale  # union rate over pattern shards
            true_rate = true_rate * rate_scale
            if rate <= rate_cap(cost):
                if objective == "refined" and refinable(q):
                    # device: probe + on-device exact-gram refinement of
                    # ALL candidates; host: native walk of the TRUE-gram
                    # residue only (bloom fp never crosses the D2H)
                    dev_ns = (
                        cost * PROBE_NS_PER_UNIT
                        + REFINE_FIXED_NS_PER_BYTE / s
                        + rate * REFINE_HEADROOM * REFINE_NS_PER_SLOT
                    )
                    host_ns = true_rate * verify_ns_per_cand
                    obj = max(dev_ns, host_ns) + 0.05 * (dev_ns + host_ns)
                elif objective in ("joint", "refined"):
                    # unrefinable config under the refined objective
                    # (q*bits > 64): the session runs it UNREFINED, so
                    # price the host-verify pipeline it will actually get
                    probe_ns = cost * PROBE_NS_PER_UNIT
                    ver_ns = rate * verify_ns_per_cand
                    # probe (device) and verify (host/device stage)
                    # overlap in the pipeline: the slower stage IS the
                    # throughput; the small sum term breaks ties toward
                    # less total work
                    obj = max(probe_ns, ver_ns) + 0.05 * (probe_ns + ver_ns)
                else:
                    obj = cost + rate * VERIFY_UNITS
                if best is None or obj < best[0]:
                    best = (obj, q, s, w, k, v)
                return True
            if fallback is None or rate < fallback[0] or (
                rate == fallback[0] and cost < fallback[1]
            ):
                fallback = (rate, cost, q, s, w, k, v)
            return False

        # the legacy probe objective is monotone in v (more filter only
        # costs), so its v loop breaks at first eligibility; the joint/
        # refined objectives are NOT (more filter can pay for itself in
        # verify savings) — scan every v
        scan_all_v = objective in ("joint", "refined")

        if force is not None:
            mode = "none"  # skip the search entirely: a forced config
            # must not pay the chooser's per-(q,w) winnowing passes
            # (minutes at 100k+ patterns — the sharded build forces
            # S-1 of its S shard filters, parallel/pshard.py)
        if mode in ("auto", "strided"):
            for q in range(1, q_max + 1):
                for s in range(q, min(max_stride, lmin - q + 1) + 1):
                    n = n_est(q, s)
                    tr = true_rate_of(q, n, s=s)
                    for k in range(2, max_k + 1):
                        v = 1
                        while v <= max_v:
                            rate = candidate_rate(q, n, k, v, s=s)
                            c = probe_cost(q, k, v, s=s)
                            if consider(rate, tr, c, q, s, 0, k, v) and (
                                not scan_all_v
                            ):
                                break
                            v *= 2
        if mode in ("auto", "sampled"):
            # sampled mode exists for huge pattern sets, where bloom
            # capacity is the wall — let its v range stretch far past the
            # strided default (the words array tops out at k16 x v256 x
            # 512 B = 2 MB, still L2-resident). At 300k patterns and
            # v<=32 the filter holds 286k fingerprints at fp
            # 0.15/position — a 3.8e-2/byte candidate flood no verifier
            # absorbs; v=64-256 restores usable fp at 300k-1M patterns.
            max_v_s = max(max_v, 256)
            for q in range(1, min(8, lmin) + 1):
                w_full = lmin - q + 1
                for w in sorted({min(w_full, x) for x in (4, 8, 16)}):
                    if w < 1:
                        continue
                    n = n_sampled(q, w)
                    tr = true_rate_of(q, n, w=w)
                    for k in range(2, max_k + 1):
                        v = 1
                        while v <= max_v_s:
                            rate = candidate_rate(q, n, k, v, w=w)
                            c = probe_cost(q, k, v, w=w)
                            if consider(rate, tr, c, q, 1, w, k, v) and (
                                not scan_all_v
                            ):
                                break
                            v *= 2
        if force is not None:
            fmode, q, sw, k, v = force
            s, w = (sw, 0) if fmode == "strided" else (1, sw)
            if fmode == "strided" and not (q <= s <= lmin - q + 1):
                raise ValueError(f"forced stride violates q<=s<=Lmin-q+1: {force}")
            if fmode == "sampled" and not (1 <= sw <= lmin - q + 1):
                raise ValueError(f"forced w violates 1<=w<=Lmin-q+1: {force}")
        elif best is not None:
            _, q, s, w, k, v = best
        else:
            _, _, q, s, w, k, v = fallback
        stride = s
        mix1 = mix1_full[:q]
        mix2 = mix2_full[:q]
        if w:
            grams = _winnow_grams(pats, q, w, mix1)
        else:
            grams = set()
            for p in pats:
                grams.update(_grams_of(p, q, range(stride)))
        n = len(grams)

        cfg = BloomConfig(q=q, stride=stride, kbanks=k, v=v,
                          mix1=mix1, mix2=mix2, fold_case=fold_case,
                          sampled=bool(w), w=w)

        words = np.zeros((k, v, 128), np.uint32)
        if grams:
            g = np.asarray(sorted(grams), np.uint64).reshape(n, q)
            m1 = np.zeros(n, np.uint64)
            m2 = np.zeros(n, np.uint64)
            for i in range(q):
                m1 = (m1 + g[:, i] * np.uint64(mix1[i])) & np.uint64(MASK32)
                m2 = (m2 + g[:, i] * np.uint64(mix2[i])) & np.uint64(MASK32)
            for b in range(k):
                vi, w7, bit = _hash_fields_np(m1, m2, np.uint64(b), v)
                np.bitwise_or.at(
                    words[b],
                    (vi.astype(np.int64), w7.astype(np.int64)),
                    np.uint32(1) << bit.astype(np.uint32),
                )
        dens = [
            float(np.unpackbits(words[b].view(np.uint8)).mean())
            for b in range(k)
        ]
        from pattern_matching.utils.debug import dprint

        dprint(
            1,
            "bloom build: mode=%s q=%d stride=%d w=%d k=%d v=%d grams=%d "
            "fp_est=%.3g",
            "sampled" if w else "strided", q, stride, w, k, v, n,
            float(np.prod(dens)),
        )
        if q * sym_bits <= 64:
            from .exact_gram import pack_grams

            gram_keys = pack_grams(grams, q, sym_bits)
        else:
            gram_keys = None
        return BloomFilterTable(
            words=words.view(np.int32),
            cfg=cfg,
            max_pat_len=lmax,
            n_grams=n,
            fp_est=float(np.prod(dens)),
            gram_keys=gram_keys,
            alphabet_size=alphabet_size,
        )

    def expected_cand_rate(self) -> float:
        """Modeled candidates per input byte: true-gram occurrences on
        uniform data (the filter cannot erase a gram that IS in the set)
        plus the measured-density bloom fp, de-amortized by the sampling
        mode — the chooser's candidate_rate at the CHOSEN config, exposed
        for capacity sizing (the refined-probe k_ref bucket)."""
        cfg = self.cfg
        true = self.n_grams / float(self.alphabet_size) ** cfg.q
        per_pos = min(1.0, true) + self.fp_est
        if cfg.sampled:
            return per_pos * 2.0 / (cfg.w + 1)
        return per_pos / cfg.stride

    def put(self, sharding=None) -> "DeviceBloom":
        put = (
            (lambda x: jax.device_put(x, sharding))
            if sharding is not None
            else jax.device_put
        )
        return DeviceBloom(words=put(self.words), cfg=self.cfg,
                           max_pat_len=self.max_pat_len)

    # -- serialization (compiled-filter dump, like DfaTable.save/load) ------

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            words=self.words,
            **config_arrays(self.cfg),
            max_pat_len=np.int64(self.max_pat_len),
            n_grams=np.int64(self.n_grams),
            fp_est=np.float64(self.fp_est),
            alphabet_size=np.int64(self.alphabet_size),
            **(
                {"gram_keys": self.gram_keys}
                if self.gram_keys is not None
                else {}
            ),
        )

    @staticmethod
    def load(path: str) -> "BloomFilterTable":
        z = np.load(path)
        return BloomFilterTable(
            words=z["words"],
            cfg=config_from_arrays(z, path),
            max_pat_len=int(z["max_pat_len"]),
            n_grams=int(z["n_grams"]),
            fp_est=float(z["fp_est"]),
            gram_keys=z["gram_keys"] if "gram_keys" in z.files else None,
            alphabet_size=int(z["alphabet_size"]),
        )


DUMP_FORMAT = 2  # version of the config layout in filter dumps


def config_arrays(cfg: BloomConfig) -> dict:
    """The npz fields that store a BloomConfig (flat and sharded dumps)."""
    return dict(
        cfg_format=np.int64(DUMP_FORMAT),
        cfg=np.array(
            [cfg.q, cfg.stride, cfg.kbanks, cfg.v, int(cfg.fold_case),
             int(cfg.sampled), cfg.w],
            dtype=np.int64,
        ),
        mix1=np.asarray(cfg.mix1, np.int64),
        mix2=np.asarray(cfg.mix2, np.int64),
    )


def config_from_arrays(z, path: str) -> BloomConfig:
    """Inverse of :func:`config_arrays`. Dumps of an older layout are
    refused: their config carries lane-tile and kernel-layout fields the
    probe no longer has."""
    if "cfg_format" not in z.files or int(z["cfg_format"]) != DUMP_FORMAT:
        raise ValueError(
            f"{path}: bloom filter dump in an older format; rebuild it "
            f"from the patterns (--save-bloom)"
        )
    c = z["cfg"]
    return BloomConfig(
        q=int(c[0]), stride=int(c[1]), kbanks=int(c[2]), v=int(c[3]),
        mix1=tuple(int(x) for x in z["mix1"]),
        mix2=tuple(int(x) for x in z["mix2"]),
        fold_case=bool(c[4]), sampled=bool(c[5]), w=int(c[6]),
    )


# ---------------------------------------------------------------- the probe


def _symbols(d, cfg: BloomConfig):
    """int32 symbols, ASCII-folded when the filter was built nocase."""
    d = d.astype(jnp.int32)
    if cfg.fold_case:
        d = jnp.where((d >= 65) & (d <= 90), d + 32, d)
    return d


def _bank_hits(m1, m2, words, cfg: BloomConfig):
    """AND over the k banks of the filter bit each position's hash picks:
    one gather from the flat [k*v*128] word array per bank (the whole
    filter is k*v*512 bytes, so the loads stay in L1/L2)."""
    flat = words.reshape(-1)
    hit = None
    for b in range(cfg.kbanks):
        h = m1 + jnp.int32(b) * m2
        h = h ^ jax.lax.shift_right_logical(h, 13)
        vi = jax.lax.shift_right_logical(h, 17) & (cfg.v - 1)
        w7 = jax.lax.shift_right_logical(h, 10) & 127
        bit = jax.lax.shift_right_logical(h, 5) & 31
        word = flat.at[(b * cfg.v + vi) * 128 + w7].get(
            mode="promise_in_bounds"
        )
        ok = (jax.lax.shift_right_logical(word, bit) & 1) == 1
        hit = ok if hit is None else hit & ok
    return hit


def _strided_hits(d, bounds, words, cfg: BloomConfig):
    """[C, T/stride] survivors of the grams at rows 0, s, 2s, ... Strided
    grams never cross a stride group (q <= s), so each reads its own
    row of the [C, T/s, s] view."""
    C, T = d.shape
    s, q = cfg.stride, cfg.q
    g = d.reshape(C, T // s, s)
    m1 = jnp.zeros((C, T // s), jnp.int32)
    m2 = jnp.zeros((C, T // s), jnp.int32)
    for qi in range(q):
        m1 = m1 + g[:, :, qi] * jnp.int32(cfg.mix1[qi])
        m2 = m2 + g[:, :, qi] * jnp.int32(cfg.mix2[qi])
    rows = jax.lax.broadcasted_iota(jnp.int32, (1, T // s), 1) * s
    start_t = bounds[0][:, None]
    end_t = bounds[1][:, None]
    # a candidate gram must lie inside the lane's valid span (rows >=
    # end_t - q + 1 can't start a gram of a match; empty and padding
    # lanes have start_t == end_t)
    live = (rows + q <= end_t) & (end_t > start_t)
    return _bank_hits(m1, m2, words, cfg) & live


def _sampled_hits(d, bounds, words, cfg: BloomConfig):
    """[C, T] survivors under winnowing selection (cfg.sampled): every
    row hashes; a row is tested iff it is the rightmost-argmin of some
    w-window of the selection hash.

    Selection rule: position p is selected iff a + b >= w - 1, where a =
    #consecutive predecessors with h >= h[p] and b = #consecutive
    successors with h > h[p] — exactly "p is the rightmost-argmin of at
    least one w-window", matching the builder's per-window fingerprint
    insertion (_winnow_offsets). Out-of-span positions get h = INT32_MAX
    (they can only make neighbors MORE selected, never suppress a
    guaranteed fingerprint — windows fully inside an occurrence are
    unaffected)."""
    C, T = d.shape
    q, w = cfg.q, cfg.w
    ext = jnp.pad(d, ((0, 0), (0, q - 1)))
    m1 = jnp.zeros((C, T), jnp.int32)
    m2 = jnp.zeros((C, T), jnp.int32)
    for qi in range(q):
        m1 = m1 + ext[:, qi : qi + T] * jnp.int32(cfg.mix1[qi])
        m2 = m2 + ext[:, qi : qi + T] * jnp.int32(cfg.mix2[qi])
    # selection hash (31-bit so INT32_MAX is a clean +inf sentinel)
    hs = (m1 ^ jax.lax.shift_right_logical(m1, 13)) & jnp.int32(0x7FFFFFFF)
    rows = jax.lax.broadcasted_iota(jnp.int32, (1, T), 1)
    start_t = bounds[0][:, None]
    end_t = bounds[1][:, None]
    valid = (rows >= start_t) & (rows + q <= end_t) & (end_t > start_t)
    inf = jnp.int32(0x7FFFFFFF)
    hm = jnp.where(valid, hs, inf)
    hp = jnp.pad(hm, ((0, 0), (w - 1, w - 1)), constant_values=inf)

    def shifted(k):  # hm[p + k] for every p, INT32_MAX off the lane
        return hp[:, w - 1 + k : w - 1 + k + T]

    # b >= k (cumulative): successors strictly greater
    ones = jnp.ones((C, T), jnp.bool_)
    succ = [ones]
    r = ones
    for kk in range(1, w):
        r = r & (shifted(kk) > hm)
        succ.append(r)
    sel = succ[w - 1]
    # a >= j (cumulative): predecessors greater-or-equal
    pred = ones
    for j in range(1, w):
        pred = pred & (shifted(-j) >= hm)
        sel = sel | (pred & succ[w - 1 - j])
    return sel & valid & _bank_hits(m1, m2, words, cfg)


def _pad_batch(data, bounds, cfg: BloomConfig):
    """Pad a lane-major batch to [Cp, Tp]: lanes to a multiple of 128
    (pad lanes get start == end, so they never survive) and rows to
    ``tile_rows``, so every 32 tested rows fill one bitmap word."""
    C, T = data.shape
    tt = cfg.tile_rows
    Tp = -(-T // tt) * tt
    Cp = -(-C // 128) * 128
    data = jnp.pad(data, ((0, Cp - C), (0, Tp - T)))
    bounds = jnp.pad(bounds, ((0, 0), (0, Cp - C)))
    return data, bounds


@functools.partial(jax.jit, static_argnames=("cfg",))
def _probe_bits_jit(data, bounds, words, *, cfg: BloomConfig):
    """bits[w, c] bit b set <=> the gram starting at row ((w*32+b)*stride)
    of lane c survives all banks and the lane mask.

    data: [C, T] lane-major symbols (uint8/uint16); bounds: [2, C]
    start_t/end_t; words: [k, v, 128] int32. The bitmap covers the padded
    batch: W = Tp / (32*stride) words over Cp = roundup(C, 128) lanes.
    Plain XLA: hash, gather, bit test and mask fuse into a few kernels."""
    d, bounds = _pad_batch(data, bounds, cfg)
    d = _symbols(d, cfg)
    hit = (_sampled_hits if cfg.sampled else _strided_hits)(
        d, bounds, words, cfg
    )
    Cp, R = hit.shape
    packed = jnp.sum(
        hit.reshape(Cp, R // 32, 32).astype(jnp.uint32)
        << jnp.arange(32, dtype=jnp.uint32),
        axis=-1,
        dtype=jnp.uint32,
    )
    return jax.lax.bitcast_convert_type(packed, jnp.int32).T


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BloomHits:
    """Survivor bitmap for one batch.

    ``total`` (meta[0]) is the exact survivor count; ``bits[w, c]`` bit b is
    the gram starting at row (w*32+b)*stride of lane c. The bitmap is
    complete — no capacity cap, no overflow mode; the host fetches it only
    when total > 0 (two transfers per batch, like the dense engine).

    ``data``/``bounds`` are the device-resident batch arrays the probe
    scanned, kept so a device-side verify stage (ops/verify_device.py) can
    walk candidate windows without re-uploading; None on the host-verify
    path."""

    meta: jax.Array  # [1] int32: total
    bits: jax.Array  # [W, C] int32
    data: jax.Array | None = None  # [C, T] symbols (device)
    bounds: jax.Array | None = None  # [2, C] (device)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _hits_jit(data, bounds, words, *, cfg):
    """Probe + popcount: lane-major data in, (total [1], bits [W, Cp])."""
    bits = _probe_bits_jit(data, bounds, words, cfg=cfg)
    total = jnp.sum(jax.lax.population_count(bits))
    from pattern_matching.utils.debug import kernel_debug

    kernel_debug("bloom batch: {} survivor grams", total)  # TPM_DEBUG>=2
    return total.reshape(1), bits


@functools.partial(
    jax.jit, static_argnames=("cfg", "exact_meta", "k_ref"),
)
def _hits_refined_jit(
    data, bounds, words, exact_lo, exact_hi, *, cfg, exact_meta, k_ref,
):
    """Probe + exact-gram refinement in one jit: the emitted bitmap keeps
    only candidates whose gram is LITERALLY in the inserted set.

    The bloom fp component never reaches the host: survivors compact
    (verify_device.bitmap_to_candidates), check against the exact table
    (ops/exact_gram.py, ~dmax+q gathers per slot), and the survivors
    scatter back into a fresh bitmap (distinct candidates hit distinct
    (word, bit), so scatter-add IS bitwise or). meta[0] is the refined
    total — on clean traffic usually 0, so the host skips the bitmap
    fetch entirely. If candidates exceed the k_ref capacity bucket the
    ORIGINAL bitmap and total pass through unchanged (the host verifier
    absorbs the flood — graceful, never lossy; match-saturated input is
    its regime anyway). Erasing non-member grams preserves exactness by
    the candidate-subset argument (ops/verify_device.py docstring)."""
    C, T = data.shape
    bits = _probe_bits_jit(data, bounds, words, cfg=cfg)
    total0 = jnp.sum(jax.lax.population_count(bits))

    from .exact_gram import DeviceExact, exact_member
    from .verify_device import bitmap_to_candidates

    n_cand, lane, row, over = bitmap_to_candidates(bits, cfg.stride, k_ref)
    dx = DeviceExact.from_meta(exact_lo, exact_hi, cfg.q, True, exact_meta)
    slotv = (
        jax.lax.broadcasted_iota(jnp.int32, (k_ref, 1), 0).squeeze(-1)
        < n_cand
    )
    base = jnp.minimum(lane, C - 1) * T + jnp.minimum(row, T - 1)
    keep = exact_member(dx, data.reshape(-1), base, slotv)
    W, Cb = bits.shape
    bitrow = row // cfg.stride  # row = (word*32 + bit) * stride
    w_i = jax.lax.shift_right_logical(bitrow, 5)
    b_i = bitrow & 31
    flat = jnp.where(keep, w_i * Cb + jnp.minimum(lane, Cb - 1), W * Cb)
    ref = (
        jnp.zeros((W * Cb,), jnp.int32)
        .at[flat]
        .add(jax.lax.shift_left(jnp.int32(1), b_i), mode="drop")
        .reshape(W, Cb)
    )
    total = jnp.where(over, total0, jnp.sum(keep.astype(jnp.int32)))
    bits_out = jnp.where(over, bits, ref)
    from pattern_matching.utils.debug import kernel_debug

    kernel_debug(
        "bloom batch: {} survivors, {} after exact-gram refinement",
        total0, total,
    )  # TPM_DEBUG>=2
    return total.reshape(1), bits_out


@dataclasses.dataclass
class DeviceBloom:
    words: jax.Array  # [k, v, 128] int32
    cfg: BloomConfig
    max_pat_len: int
    exact_lo: jax.Array | None = None  # exact-gram refinement planes
    exact_hi: jax.Array | None = None
    exact_meta: tuple | None = None
    k_ref: int = 0  # refinement candidate-capacity bucket

    def attach_exact(
        self, gram_keys, k_ref: int, sharding=None, bits: int = 8
    ) -> None:
        """Enable exact-gram refinement on this probe: candidates whose
        gram is not in ``gram_keys`` (the builder's inserted set) never
        reach the host. ``k_ref`` is the static candidate-capacity bucket
        (size from BloomFilterTable.expected_cand_rate x batch bytes —
        overflow passes the unrefined bitmap through, graceful).
        ``bits`` is the gram_keys symbol width
        (BloomFilterTable.gram_bits)."""
        from .exact_gram import table_from_keys

        put = (
            (lambda x: jax.device_put(x, sharding))
            if sharding is not None
            else jax.device_put
        )
        xt = table_from_keys(gram_keys, self.cfg.q, bits=bits)
        self.exact_lo = put(xt.lo.view(np.int32))
        self.exact_hi = put(xt.hi.view(np.int32)) if xt.use_hi else None
        self.exact_meta = xt.device_meta(self.cfg.fold_case)
        self.k_ref = int(k_ref)

    def hits(self, data, bounds) -> BloomHits:
        """data: [C, T] lane-major symbols; bounds: [2, C] start_t/end_t."""
        if self.exact_meta is not None:
            meta, bits = _hits_refined_jit(
                data, bounds, self.words, self.exact_lo, self.exact_hi,
                cfg=self.cfg, exact_meta=self.exact_meta, k_ref=self.k_ref,
            )
            return BloomHits(meta=meta, bits=bits)
        meta, bits = _hits_jit(data, bounds, self.words, cfg=self.cfg)
        return BloomHits(meta=meta, bits=bits)

    def probe_total(self, data, start_t, end_t, halo: int = 0):
        """Benchmark hook: total survivors (forces the full probe)."""
        meta, _ = _hits_jit(
            data, jnp.stack([start_t, end_t]), self.words, cfg=self.cfg
        )
        return meta[0]


def unpack_hit_rows(bits: np.ndarray, stride: int):
    """Host-side bitmap expansion: [W, C] int32 -> (rows, lanes) arrays of
    candidate gram start rows (already in row units, halo included).

    Native ctz loop when the oracle library is buildable (the NumPy
    expansion measured ~9.5 ms of the ~21 ms per-batch decode budget at
    40k candidates — host decode shares one core with the feeder here);
    NumPy fallback is proportional to NONZERO words, not the bitmap."""
    u = bits.view(np.uint32) if bits.dtype == np.int32 else bits
    try:
        from pattern_matching.core.oracle_native import unpack_bitmap

        return unpack_bitmap(u, stride)
    except Exception:
        pass
    wi, ci = np.nonzero(u)
    if len(wi) == 0:
        z = np.zeros(0, np.int64)
        return z, z
    vals = u[wi, ci]
    planes = (vals[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    k, bit = np.nonzero(planes)
    rows = (wi[k].astype(np.int64) * 32 + bit) * stride
    return rows, ci[k].astype(np.int64)
