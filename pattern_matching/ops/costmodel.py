"""Device-calibrated cost-model constants for the bloom chooser.

The chooser (ops/bloom.BloomFilterTable.build) prices candidate configs
with four measured constants: probe ns per model cost-unit, exact-gram
refinement ns per capacity slot (+ a fixed per-byte term for the stage-1
top_k), and host-verify ns per candidate. On another device (or host
CPU) fixed numbers would silently optimize the wrong objective, so they
are data:

- :class:`CostConstants` — the four constants + provenance, JSON
  round-trippable;
- :func:`get_cost_constants` — resolution order: ``TPM_COST_CONSTANTS``
  env path, then the user cache file (written by calibrate), then the
  shipped defaults (a ``calibrate()`` run on the device named in
  ``source``). A cache file calibrated on another device kind is
  refused loudly. The chooser calls this per build;
- :func:`calibrate` — times micro-benches on the attached device (best
  of several ``block_until_ready`` calls) and on the host, writes the
  cache file, returns the constants. Explicit opt-in:
  ``python -m pattern_matching.ops.costmodel`` — never run implicitly
  (it compiles and times several probe shapes, and a library import must
  never pay that).

The reference has no analogue — its only tuning knob is the local work
size flag (``-L``, ocl_aho_grep.c:411-459); kernel cost is whatever the
OpenCL driver delivers. A chooser that picks among hundreds of
(mode, q, stride/w, k, v) configs needs priced hardware.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

ENV_VAR = "TPM_COST_CONSTANTS"
DEFAULT_PATH = os.path.join(
    os.path.expanduser("~"), ".cache", "pattern_matching",
    "cost_constants.json",
)


@dataclasses.dataclass(frozen=True)
class CostConstants:
    """The chooser's priced-hardware constants.

    Defaults are a ``calibrate()`` run at the 10k x 12B point on the
    device named in ``source`` (device kind and power limit):

    - ``probe_ns_per_unit``: ns/byte per probe-cost model unit
      (ops/bloom.probe_cost_units).
    - ``refine_ns_per_slot``: exact-gram refinement marginal cost per
      capacity SLOT (stage-2 compaction + q gram gathers + dmax exact
      probes + scatter-back, linear in k_ref).
    - ``refine_fixed_ns_per_byte``: stage-1 top_k over the word bitmap,
      per input byte at one bitmap bit per position (strided bitmaps
      have 1/stride the words — the chooser divides by stride).
    - ``verify_ns_per_cand``: host native-walker cost per candidate,
      including bitmap unpack + window merge.

    The ``*_u2048`` fields are alphabet-2048 (ushort) overrides: the
    probe walks uint16 lanes and the host verifier walks token windows,
    so their costs differ from the byte alphabet. ``None`` falls back to
    the byte constants; ``calibrate()`` fills the probe/verify points
    (refinement cost per slot is capacity-bound, not symbol-width-bound,
    so the byte values carry over and no ushort refine fields exist).
    """

    probe_ns_per_unit: float = 0.0006688500215233206
    refine_ns_per_slot: float = 1.0  # the calibrator's floor: the
    # per-slot marginal measured below timing noise on this device
    refine_fixed_ns_per_byte: float = 0.10895081659037653
    verify_ns_per_cand: float = 629.9341617636265
    probe_ns_per_unit_u2048: float | None = 0.0005648732838515308
    verify_ns_per_cand_u2048: float | None = 581.8090692132276
    source: str = "calibrated:gpu:NVIDIA H100 80GB HBM3:400.00 W"

    def for_alphabet(self, alphabet_size: int) -> "CostConstants":
        """The constants a build at ``alphabet_size`` should price with:
        the byte numbers, with any calibrated ushort overrides swapped in
        for non-byte alphabets (without them a ushort build on a
        fresh machine used byte-derived verify pricing)."""
        if alphabet_size == 256:
            return self
        repl = {
            f: getattr(self, f + "_u2048")
            for f in ("probe_ns_per_unit", "verify_ns_per_cand")
            if getattr(self, f + "_u2048") is not None
        }
        return dataclasses.replace(self, **repl) if repl else self

    def save(self, path: str = DEFAULT_PATH) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=1)
        os.replace(tmp, path)
        return path

    @staticmethod
    def load(path: str) -> "CostConstants":
        with open(path) as f:
            d = json.load(f)
        fields = {f.name for f in dataclasses.fields(CostConstants)}
        # a file without ushort points prices ushort builds with its own
        # byte constants, not with the shipped ushort defaults
        for f in fields:
            if f.endswith("_u2048"):
                d.setdefault(f, None)
        unknown = set(d) - fields
        if unknown:
            raise ValueError(
                f"{path}: unknown cost-constant keys {sorted(unknown)}"
            )
        for k, v in d.items():
            if k == "source" or (k.endswith("_u2048") and v is None):
                continue
            if not isinstance(v, (int, float)) or v <= 0:
                raise ValueError(f"{path}: {k} must be a positive number")
        return CostConstants(**d)


def get_cost_constants(alphabet_size: int = 256) -> CostConstants:
    """Resolve the active constants: env-var path > cache file > defaults,
    then apply any alphabet-specific overrides (:meth:`for_alphabet`).

    A broken file, or one calibrated on another device kind than the
    attached one, falls back LOUDLY to the defaults (stderr) rather than
    failing the build — a stale calibration must never stop matching."""
    import sys

    path = os.environ.get(ENV_VAR) or DEFAULT_PATH
    if os.path.exists(path):
        try:
            cc = CostConstants.load(path)
            here = device_label()
            there = calibrated_device(cc.source)
            if there is not None and there != here:
                raise ValueError(
                    f"calibrated on {there!r}, attached device is {here!r}"
                )
            return cc.for_alphabet(alphabet_size)
        except (OSError, ValueError, TypeError) as e:
            print(
                f"WARNING: cost-constants file {path} unusable ({e}); "
                f"using the shipped defaults ({CostConstants().source})",
                file=sys.stderr,
            )
    return CostConstants().for_alphabet(alphabet_size)


def device_label() -> str:
    """``platform:device_kind`` of the attached device — the part of a
    calibration's ``source`` that must match for it to apply."""
    import jax

    dev = jax.devices()[0]
    return f"{dev.platform}:{dev.device_kind}"


def calibrated_device(source: str) -> str | None:
    """The ``platform:device_kind`` a ``calibrate()`` source names
    (``calibrated:<platform>:<kind>[:<power limit>]``), else None."""
    parts = source.split(":")
    if parts[0] != "calibrated" or len(parts) < 3:
        return None
    return f"{parts[1]}:{parts[2]}"


def power_limit() -> str:
    """The card's power limit as nvidia-smi reports it ("?" without one):
    a card set below its maximum runs slower under load, so every number
    names it."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return "?"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "?"


# --------------------------------------------------------------- calibration


def _device_seconds(fn, n: int = 10) -> float:
    """Best-of-n seconds of ``fn()`` through ``block_until_ready`` (after
    one warm-up call that compiles)."""
    import time

    import jax

    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def calibrate(
    path: str | None = DEFAULT_PATH,
    n_patterns: int = 10_000,
    verbose: bool = True,
) -> CostConstants:
    """Measure the four constants on the attached device/host and cache
    them (pass ``path=None`` to skip writing)."""
    import sys
    import time

    import jax

    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.ops.bloom import (
        BloomFilterTable,
        _hits_jit,
        _hits_refined_jit,
        probe_cost_units,
        unpack_hit_rows,
    )
    from pattern_matching.ops.exact_gram import table_from_keys
    from pattern_matching.runtime.verify import Verifier
    from pattern_matching.utils.common import pad_halo

    def log(msg):
        if verbose:
            print(f"calibrate: {msg}", file=sys.stderr)

    rng = np.random.RandomState(42)
    pats = [
        bytes(rng.randint(0, 256, size=12).astype(np.uint8))
        for _ in range(n_patterns)
    ]
    table = compile_patterns(pats)
    bft = BloomFilterTable.from_table(table)  # refined-objective pick
    cfg = bft.cfg
    # the official bench batch shape (~16 MiB): per-batch constants (the
    # stage-1 top_k, dispatch bookkeeping) must amortize over the same
    # bytes the product amortizes them over, or the per-byte fixed term
    # reads high (measured 10x at a quarter-size batch)
    C, B0 = 4096, 4096
    halo = pad_halo(table.max_pat_len - 1, B0)
    B = B0 + (-(halo + B0)) % cfg.tile_rows
    size = C * B
    units = probe_cost_units(
        cfg.q, cfg.kbanks, cfg.v, s=cfg.stride if not cfg.sampled else 1,
        w=cfg.w if cfg.sampled else 0,
    )
    data_np = rng.randint(0, 256, size=(C, halo + B)).astype(np.uint8)
    # plant ~1e-3 true-gram density so host verify sees real candidates
    n_seed = max(64, int(size * 1e-3) // 12)
    lanes_s = rng.randint(0, C, size=n_seed)
    pos_s = rng.randint(halo, halo + B - 12, size=n_seed)
    chosen = rng.randint(0, n_patterns, size=n_seed)
    for k in range(12):
        data_np[lanes_s, pos_s + k] = [pats[c][k] for c in chosen]
    data = jax.device_put(data_np)
    start_np = np.full(C, halo, np.int32)
    end_np = np.full(C, halo + B, np.int32)
    bounds = jax.device_put(np.stack([start_np, end_np]))
    words = jax.device_put(bft.words)

    # ---- 1. probe ns per cost unit ----------------------------------------
    probe_s = _device_seconds(
        lambda: _hits_jit(data, bounds, words, cfg=cfg)
    )
    probe_ns_per_unit = probe_s * 1e9 / size / units
    log(
        f"probe {size / probe_s / 1e9:.2f} GB/s at {units:.0f} units -> "
        f"{probe_ns_per_unit:.2e} ns/unit"
    )

    # ---- 2+3. refinement slot marginal + fixed term ------------------------
    xt = table_from_keys(bft.gram_keys, cfg.q)
    exact_lo = jax.device_put(xt.lo.view(np.int32))
    exact_hi = jax.device_put(xt.hi.view(np.int32)) if xt.use_hi else None
    exact_meta = xt.device_meta(cfg.fold_case)

    def refined_s(k_ref):
        return _device_seconds(lambda: _hits_refined_jit(
            data, bounds, words, exact_lo, exact_hi, cfg=cfg,
            exact_meta=exact_meta, k_ref=k_ref,
        ))

    k_a, k_b = 4096, 24576
    t_a, t_b = refined_s(k_a), refined_s(k_b)
    refine_ns_per_slot = max(1.0, (t_b - t_a) * 1e9 / (k_b - k_a))
    s_eff = 1 if cfg.sampled else cfg.stride
    refine_fixed_ns_per_byte = max(
        1e-4,
        (t_a - probe_s - k_a * refine_ns_per_slot * 1e-9) * 1e9 / size
        * s_eff,
    )
    log(
        f"refine {refine_ns_per_slot:.0f} ns/slot, fixed "
        f"{refine_fixed_ns_per_byte:.3f} ns/byte (stride-normalized)"
    )

    # ---- 4. host verify ns per candidate ----------------------------------
    meta, bits = _hits_jit(data, bounds, words, cfg=cfg)
    n_cand = int(np.asarray(meta)[0])
    bits_np = np.asarray(bits)
    verifier = Verifier(
        [p.symbols for p in table.patterns],
        q=cfg.q, max_pat_len=table.max_pat_len, dense_table=table,
    )
    host = float("inf")
    for _ in range(4):
        t0 = time.perf_counter()
        rows, lanes = unpack_hit_rows(bits_np, cfg.stride)
        verifier.verify_batch_arrays(
            data_np, lanes, rows, halo, start_np, end_np
        )
        host = min(host, time.perf_counter() - t0)
    verify_ns_per_cand = host * 1e9 / max(1, n_cand)
    log(f"host verify {verify_ns_per_cand:.0f} ns/cand ({n_cand} cands)")

    # ---- 5. ushort-alphabet probe + verify point ---------------------------
    # the byte point alone would leave alphabet-2048 builds priced with
    # byte-derived constants. The probe walks uint16 lanes
    # (different gather/width costs) and the host verifier walks token
    # windows; measure both at a signature-scale set (AC_ushorts ships
    # 1.7-2.4k signatures, iacsmx.h:43 I_ALPHABET_SIZE 2048).
    u_pats = [
        tuple(int(x) for x in rng.randint(0, 2048,
                                          size=rng.randint(4, 13)))
        for _ in range(2000)
    ]
    u_table = compile_patterns(u_pats, alphabet_size=2048)
    u_bft = BloomFilterTable.from_table(u_table)
    u_cfg = u_bft.cfg
    uC, uB0 = 2048, 4096
    u_halo = pad_halo(u_table.max_pat_len - 1, uB0)
    uB = uB0 + (-(u_halo + uB0)) % u_cfg.tile_rows
    u_size = uC * uB
    u_units = probe_cost_units(
        u_cfg.q, u_cfg.kbanks, u_cfg.v,
        s=u_cfg.stride if not u_cfg.sampled else 1,
        w=u_cfg.w if u_cfg.sampled else 0,
    )
    u_data_np = rng.randint(0, 2048, size=(uC, u_halo + uB)).astype(
        np.uint16
    )
    u_seed = max(64, int(u_size * 1e-3) // 8)
    u_lanes = rng.randint(0, uC, size=u_seed)
    u_pos = rng.randint(u_halo, u_halo + uB - 13, size=u_seed)
    for ln, pos, ci in zip(
        u_lanes, u_pos, rng.randint(0, len(u_pats), size=u_seed)
    ):
        p = u_pats[ci]
        u_data_np[ln, pos : pos + len(p)] = p
    u_data = jax.device_put(u_data_np)
    u_start = np.full(uC, u_halo, np.int32)
    u_end = np.full(uC, u_halo + uB, np.int32)
    u_bounds = jax.device_put(np.stack([u_start, u_end]))
    u_words = jax.device_put(u_bft.words)

    u_probe_s = _device_seconds(
        lambda: _hits_jit(u_data, u_bounds, u_words, cfg=u_cfg)
    )
    probe_ns_per_unit_u2048 = u_probe_s * 1e9 / u_size / u_units
    log(
        f"ushort probe {u_size / u_probe_s / 1e9:.2f} Gtok/s at "
        f"{u_units:.0f} units -> {probe_ns_per_unit_u2048:.2e} ns/unit"
    )

    u_meta, u_bits = _hits_jit(u_data, u_bounds, u_words, cfg=u_cfg)
    u_n_cand = int(np.asarray(u_meta)[0])
    u_bits_np = np.asarray(u_bits)
    u_verifier = Verifier(
        [p.symbols for p in u_table.patterns], alphabet_size=2048,
        q=u_cfg.q, max_pat_len=u_table.max_pat_len, dense_table=u_table,
    )
    u_host = float("inf")
    for _ in range(4):
        t0 = time.perf_counter()
        rows, lanes = unpack_hit_rows(u_bits_np, u_cfg.stride)
        u_verifier.verify_batch_arrays(
            u_data_np, lanes, rows, u_halo, u_start, u_end
        )
        u_host = min(u_host, time.perf_counter() - t0)
    verify_ns_per_cand_u2048 = u_host * 1e9 / max(1, u_n_cand)
    log(
        f"ushort host verify {verify_ns_per_cand_u2048:.0f} ns/cand "
        f"({u_n_cand} cands)"
    )

    cc = CostConstants(
        probe_ns_per_unit=float(probe_ns_per_unit),
        refine_ns_per_slot=float(refine_ns_per_slot),
        refine_fixed_ns_per_byte=float(refine_fixed_ns_per_byte),
        verify_ns_per_cand=float(verify_ns_per_cand),
        probe_ns_per_unit_u2048=float(probe_ns_per_unit_u2048),
        verify_ns_per_cand_u2048=float(verify_ns_per_cand_u2048),
        source=f"calibrated:{device_label()}:{power_limit()}",
    )
    if path is not None:
        cc.save(path)
        log(f"wrote {path}")
    return cc


if __name__ == "__main__":
    import sys

    out = calibrate(
        path=sys.argv[1] if len(sys.argv) > 1 else DEFAULT_PATH
    )
    print(json.dumps(dataclasses.asdict(out)))
