"""Ushort-alphabet (packet-metadata) device scan throughput.

The AC_ushorts workload (SURVEY.md section 2.2) on the reference's REAL
signature traces (AC_ushorts/input/{tx,rx,txrx}.signatures — per-flow
packet-length trains, truncated to MAX_PATT_LEN=16 tokens like
iacsmx.c:11): alphabet-2048 bloom probe over uint16 token lanes, honest
K-loop protocol (K scans inside one jit, carry threaded
through an operand, t(K_hi) - t(K_lo)).

Reports tokens/s and uint16-payload bytes/s for (a) the probe-objective
config and (b) the session-default refined pipeline (probe + on-device
exact-gram refinement at 11-bit keys). No byte-mode number is comparable:
the reference never benchmarked this variant either (its ushort driver
predates even its own follow mode).

Usage: python benchmarks/bench_ushort.py [sig_file ...]
"""

from __future__ import annotations

import functools
import json
import sys
import time

import numpy as np

REF_SIGS = [
    "/root/reference/AC_ushorts/input/tx.signatures",
    "/root/reference/AC_ushorts/input/rx.signatures",
    "/root/reference/AC_ushorts/input/txrx.signatures",
]


def build_table(paths):
    from pattern_matching.core.dfa import ALPHABET_USHORT, AhoCorasick
    from pattern_matching.core.patterns import load_signature_file

    ac = AhoCorasick(ALPHABET_USHORT)
    seen = set()
    n_in = 0
    for p in paths:
        for pp in load_signature_file(p, max_tokens=16):
            n_in += 1
            seq = tuple(min(v, ALPHABET_USHORT - 1) for v in pp.data)
            if len(seq) < 2 or seq in seen:  # 1-token signatures match
                continue  # every occurrence of one value: not a filter
                # workload (the reference's own sets contain none)
            seen.add(seq)
            ac.add_pattern(seq, iid=len(seen) - 1, label=pp.label)
    return ac.compile(), n_in, len(seen)


def kloop_bytes_per_s(run, size_bytes, K_LO=1, K_HI=9, n=5):
    run(K_LO)
    run(K_HI)

    def best(K):
        b = float("inf")
        for _ in range(n):
            t0 = time.perf_counter()
            run(K)
            b = min(b, time.perf_counter() - t0)
        return b

    per = (best(K_HI) - best(K_LO)) / (K_HI - K_LO)
    return size_bytes / per


def main() -> None:
    import jax
    import jax.numpy as jnp

    from pattern_matching.ops.bloom import (
        BloomFilterTable,
        _hits_jit,
        _hits_refined_jit,
    )
    from pattern_matching.ops.exact_gram import table_from_keys
    from pattern_matching.ops.verify_device import next_cap
    from pattern_matching.utils.common import pad_halo

    paths = sys.argv[1:] or REF_SIGS
    table, n_in, n_used = build_table(paths)
    out = {
        "metric": "ushort_scan",
        "signatures_in": n_in,
        "signatures_used": n_used,
        "states": table.num_states,
    }
    rng = np.random.RandomState(11)
    C, B0 = 4096, 2048  # tokens per lane

    for tag, bft in (
        ("probe", BloomFilterTable.from_table(table, objective="probe")),
        ("refined", BloomFilterTable.from_table(table)),
    ):
        cfg = bft.cfg
        halo = pad_halo(table.max_pat_len - 1, B0)
        B = B0 + (-(halo + B0)) % cfg.tile_rows
        size = C * B * 2  # uint16 payload bytes
        data = jax.device_put(
            rng.randint(0, 2048, size=(C, halo + B)).astype(np.uint16)
        )
        bounds = jax.device_put(
            np.stack(
                [np.full(C, halo, np.int32), np.full(C, halo + B, np.int32)]
            )
        )
        words = jax.device_put(bft.words)
        mode = ("sampled" if cfg.sampled else "strided")
        out[f"{tag}_config"] = (
            f"{mode}_q{cfg.q}s{cfg.stride}w{cfg.w}k{cfg.kbanks}v{cfg.v}"
        )

        @functools.partial(jax.jit, static_argnames=("K",))
        def probe_rep(data, bounds, *, K, words=words, cfg=cfg):
            def body(acc, _):
                b2 = bounds.at[0, 0].add(acc & 1)
                total, _bits = _hits_jit(
                    data, b2, words, cfg=cfg)
                return acc + total[0], None

            acc, _ = jax.lax.scan(
                body, jnp.zeros((), jnp.int32), None, length=K
            )
            return acc

        bps = kloop_bytes_per_s(
            lambda K: int(probe_rep(data, bounds, K=K)), size
        )
        out[f"{tag}_probe_bytes_per_s"] = bps
        out[f"{tag}_tokens_per_s"] = bps / 2

        if tag == "refined" and bft.gram_keys is not None and len(
            bft.gram_keys
        ):
            xt = table_from_keys(
                bft.gram_keys, cfg.q, bits=bft.gram_bits
            )
            exact_lo = jax.device_put(xt.lo.view(np.int32))
            exact_hi = (
                jax.device_put(xt.hi.view(np.int32)) if xt.use_hi else None
            )
            meta = xt.device_meta(cfg.fold_case)
            k_ref = next_cap(
                int(max(2048, 2.0 * bft.expected_cand_rate() * C * B))
            )
            out["refined_k_ref"] = k_ref

            @functools.partial(jax.jit, static_argnames=("K",))
            def ref_rep(data, bounds, *, K):
                def body(acc, _):
                    b2 = bounds.at[0, 0].add(acc & 1)
                    total, _bits = _hits_refined_jit(
                        data, b2, words, exact_lo, exact_hi, cfg=cfg,
                        exact_meta=meta, k_ref=k_ref,
                    )
                    return acc + total[0], None

                acc, _ = jax.lax.scan(
                    body, jnp.zeros((), jnp.int32), None, length=K
                )
                return acc

            m0, _b0 = _hits_refined_jit(
                data, bounds, words, exact_lo, exact_hi, cfg=cfg,
                exact_meta=meta, k_ref=k_ref,
            )
            out["refined_residue_per_token"] = int(np.asarray(m0)[0]) / (
                C * B
            )
            bps = kloop_bytes_per_s(
                lambda K: int(ref_rep(data, bounds, K=K)), size
            )
            out["refined_pipeline_bytes_per_s"] = bps
            out["refined_pipeline_tokens_per_s"] = bps / 2

    print(json.dumps(out))


if __name__ == "__main__":
    main()
