"""Randomized differential campaign: every exactness path vs the oracle.

The in-suite differential tests (tests/test_differential_fuzz.py) pin a
handful of seeds so CI stays fast; this tool is the long-running burn-in
— hundreds of randomized trials over
pattern sets, corpora, and session geometries, asserting EXACT
(end_offset, pattern_index) agreement between the independent Python
oracle and every engine/verify/shard combination:

- bloom, chooser-picked config, host verify   (the flagship path)
- bloom forced strided / forced sampled       (both kernel modes)
- bloom with device verify                    (ops/verify_device.py)
- bloom with pattern shards                   (parallel/pshard.py union)
- dense XLA walk                              (exact-on-device reference)

Heavier arms run on a random subset of trials (compile cost dominates); every trial always runs at least the
chooser-picked bloom arm and the dense arm. Any divergence prints the
full reproduction tuple and the tool exits nonzero.

Usage: python tools/fuzz_campaign.py [n_trials] [master_seed]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# The campaign runs on CPU: exactness does not depend on the backend.
# TPM_FUZZ_GPU=1 opts into the real devices.
if not os.environ.get("TPM_FUZZ_GPU"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        # a small virtual device mesh so the mesh arms run in the same
        # campaign (2 devices is enough to exercise shard_map + psum +
        # the lane-sharded event/bitmap decode)
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=2"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

ALPHABETS = [2, 4, 16, 64, 256]
USHORT_ALPHABETS = [8, 64, 2048]  # token values (table width stays 2048)
USHORT_EVERY = 3  # trials also running the ushort arm set
TEXT_EVERY = 3  # trials (mod 3 == 1) also running the text-mode arm set
MESH_EVERY = 4  # trials (mod 4 == 2) also running the mesh arm set


def run_trial(trial: int, master_seed: int) -> dict:
    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.core.oracle import match_python
    from pattern_matching.runtime.session import MatchSession

    rng = np.random.RandomState(master_seed * 100_003 + trial)
    asize = ALPHABETS[rng.randint(len(ALPHABETS))]
    alphabet = np.arange(asize, dtype=np.uint8)
    n_pats = int(rng.randint(1, 41))
    lmin = int(rng.randint(1, 8))
    lmax = lmin + int(rng.randint(0, 18))
    pats: set[bytes] = set()
    tries = 0
    while len(pats) < n_pats and tries < 400:
        ln = rng.randint(lmin, lmax + 1)
        pats.add(bytes(rng.choice(alphabet, size=ln).astype(np.uint8)))
        tries += 1
    pat_list = sorted(pats)
    size = int(rng.choice([512, 1024, 3000, 8192, 16384]))
    plants = int(rng.randint(0, 60))
    data = bytearray(rng.choice(alphabet, size=size).astype(np.uint8))
    for _ in range(plants):
        p = pat_list[rng.randint(len(pat_list))]
        if len(p) <= size:
            pos = rng.randint(0, size - len(p) + 1)
            data[pos : pos + len(p)] = p
    data = bytes(data)
    chunks = int(rng.choice([2, 3, 4, 8, 16, 64]))
    clen = int(rng.choice([8, 16, 32, 64, 128, 256]))

    want = sorted(match_python(pat_list, data))
    table = compile_patterns(pat_list)
    repro = (
        f"trial={trial} seed={master_seed} asize={asize} "
        f"n={len(pat_list)} l=[{lmin},{lmax}] size={size} "
        f"plants={plants} geom=({chunks},{clen})"
    )

    arms = {"bloom_auto": dict(engine="bloom")}
    # both kernel modes when the set admits them (sampled needs
    # Lmin-q+1 >= 2 windows to differ from strided; the builder guards)
    if rng.rand() < 0.5:
        arms["bloom_strided"] = dict(
            engine="bloom", bloom_opts={"mode": "strided"}
        )
    if rng.rand() < 0.5:
        arms["bloom_sampled"] = dict(
            engine="bloom", bloom_opts={"mode": "sampled"}
        )
    if rng.rand() < 0.5:
        arms["device_verify"] = dict(engine="bloom", verify="device")
    if rng.rand() < 0.5 and len(pat_list) >= 2:
        arms["pat_shards"] = dict(
            engine="bloom",
            pat_shards=int(rng.randint(2, min(5, len(pat_list) + 1))),
        )
    import jax

    if len(jax.devices()) >= 2 and trial % MESH_EVERY == 2:
        # meshed session arms: lane-sharded probe + host decode, and the
        # round-4 MeshDeviceVerifier (lane-sharded device events)
        arms["mesh_bloom"] = dict(engine="bloom", mesh=2)
        arms["mesh_device_verify"] = dict(
            engine="bloom", mesh=2, verify="device"
        )
        if len(pat_list) >= 2:
            # round 5: device-exact events on the ("pat","data") mesh
            # (per-shard tables + host-side cross-shard event merge)
            arms["pshard_device_verify"] = dict(
                engine="bloom", mesh=2, pat_shards=2, verify="device"
            )
        # round 5: the dense engine's lane-sharded per-device compaction
        arms["mesh_dense"] = dict(engine="dense", mesh=2, max_results=256)
    arms["dense"] = dict(engine="dense", max_results=256)

    ran = []
    for name, kw in arms.items():
        got = MatchSession(
            table, max_chunks=chunks, chunk_len=clen, **kw
        ).find(data)
        if got != want:
            missing = sorted(set(want) - set(got))[:5]
            spurious = sorted(set(got) - set(want))[:5]
            raise AssertionError(
                f"{name} diverged [{repro}]: {len(got)} events vs "
                f"{len(want)} oracle; missing={missing} "
                f"spurious={spurious}"
            )
        ran.append(name)
    if trial % USHORT_EVERY == 0:
        ran += run_ushort_arms(rng)
    if trial % TEXT_EVERY == 1:
        ran += run_text_arms(rng)
    return {"events": len(want), "arms": ran}


def run_text_arms(rng) -> list[str]:
    """Text (line) mode arms: matches must not span lines, long lines
    split into halo-linked fragments, and offsets stay stream-absolute.
    Oracle = per-line match union at absolute offsets."""
    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.core.oracle import match_python
    from pattern_matching.runtime.session import MatchSession

    # printable alphabet without newline so patterns cannot span lines
    alphabet = np.frombuffer(
        bytes(range(32, 127)) + b"\t", np.uint8
    )
    n_pats = int(rng.randint(1, 16))
    lmin = int(rng.randint(1, 5))
    lmax = lmin + int(rng.randint(0, 10))
    pats: set[bytes] = set()
    tries = 0
    while len(pats) < n_pats and tries < 200:
        ln = rng.randint(lmin, lmax + 1)
        pats.add(bytes(rng.choice(alphabet, size=ln).astype(np.uint8)))
        tries += 1
    pat_list = sorted(pats)
    n_lines = int(rng.randint(1, 30))
    lines = []
    for _ in range(n_lines):
        L = int(rng.choice([0, 3, 20, 80, 400]))
        row = bytearray(rng.choice(alphabet, size=L).astype(np.uint8))
        for _ in range(int(rng.randint(0, 4))):
            p = pat_list[rng.randint(len(pat_list))]
            if len(p) <= L:
                pos = rng.randint(0, L - len(p) + 1)
                row[pos : pos + len(p)] = p
        lines.append(bytes(row))
    text = b"\n".join(lines) + b"\n"
    want = []
    off = 0
    for row in lines:
        for e, pid in match_python(pat_list, row):
            want.append((off + e, pid))
        off += len(row) + 1
    want = sorted(want)
    table = compile_patterns(pat_list)
    chunks = int(rng.choice([2, 4, 16]))
    clen = int(rng.choice([16, 64, 256]))
    arms = {
        "t_dense": dict(engine="dense", max_results=256),
        "t_bloom": dict(engine="bloom"),
    }
    ran = []
    for name, kw in arms.items():
        got = MatchSession(
            table, max_chunks=chunks, chunk_len=clen, **kw
        ).find(text, text_mode=True)
        if got != want:
            missing = sorted(set(want) - set(got))[:5]
            spurious = sorted(set(got) - set(want))[:5]
            raise AssertionError(
                f"{name} diverged [text n={len(pat_list)} l=[{lmin},{lmax}] "
                f"lines={n_lines} geom=({chunks},{clen})]: "
                f"{len(got)} vs {len(want)} oracle; missing={missing} "
                f"spurious={spurious}"
            )
        ran.append(name)
    return ran


def run_ushort_arms(rng) -> list[str]:
    """Ushort-alphabet arms through the PRODUCT path: a token sequence
    serialized as comma-separated text streams through UshortBuffer's
    incremental parser into uint16 lanes (AC_ushorts/databuf.c:154-190's
    role), then each engine's find() must equal the oracle in token
    offsets."""
    from pattern_matching.core.dfa import AhoCorasick
    from pattern_matching.core.oracle import match_python
    from pattern_matching.runtime.session import MatchSession

    asize = USHORT_ALPHABETS[rng.randint(len(USHORT_ALPHABETS))]
    n_pats = int(rng.randint(1, 21))
    lmin = int(rng.randint(1, 5))
    lmax = lmin + int(rng.randint(0, 12))
    pats: set[tuple] = set()
    tries = 0
    while len(pats) < n_pats and tries < 200:
        ln = rng.randint(lmin, lmax + 1)
        pats.add(tuple(int(x) for x in rng.randint(0, asize, size=ln)))
        tries += 1
    pat_list = sorted(pats)
    n_tok = int(rng.choice([64, 300, 1200]))
    seq = rng.randint(0, asize, size=n_tok)
    for _ in range(int(rng.randint(0, 25))):
        p = pat_list[rng.randint(len(pat_list))]
        if len(p) <= n_tok:
            pos = rng.randint(0, n_tok - len(p) + 1)
            seq[pos : pos + len(p)] = p
    want = sorted(match_python(pat_list, seq.tolist()))
    ac = AhoCorasick(alphabet_size=2048)
    for p in pat_list:
        ac.add_pattern(p)
    table = ac.compile()
    text = (",".join(str(int(x)) for x in seq)).encode()
    chunks = int(rng.choice([2, 4, 16]))
    clen = int(rng.choice([8, 32, 128]))
    arms = {
        "u_dense": dict(engine="dense", max_results=256),
        "u_bloom": dict(engine="bloom"),
    }
    if rng.rand() < 0.5:
        arms["u_device_verify"] = dict(engine="bloom", verify="device")
    import jax

    if len(jax.devices()) >= 2 and rng.rand() < 0.4:
        arms["u_mesh"] = dict(engine="bloom", mesh=2)
    ran = []
    for name, kw in arms.items():
        got = MatchSession(
            table, max_chunks=chunks, chunk_len=clen, **kw
        ).find(text)
        if got != want:
            missing = sorted(set(want) - set(got))[:5]
            spurious = sorted(set(got) - set(want))[:5]
            raise AssertionError(
                f"{name} diverged [ushort asize={asize} n={len(pat_list)} "
                f"l=[{lmin},{lmax}] n_tok={n_tok} geom=({chunks},{clen})]: "
                f"{len(got)} vs {len(want)} oracle; missing={missing} "
                f"spurious={spurious}"
            )
        ran.append(name)
    return ran


CHUNK = 50  # trials per process: one process's accumulated jit caches
# exhaust the kernel mmap budget (LLVM "Cannot allocate memory" observed
# at ~250 trials with 126 GB RAM free — vm.max_map_count, not bytes)


def main() -> None:
    n_trials = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    master_seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    start = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    t0 = time.time()
    if n_trials > CHUNK and not os.environ.get("TPM_FUZZ_CHILD"):
        # fresh process per chunk; any child divergence (assertion print +
        # nonzero exit) propagates
        import subprocess

        arm_counts: dict[str, int] = {}
        events = wall = 0.0
        done = 0
        while done < n_trials:
            k = min(CHUNK, n_trials - done)
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 str(k), str(master_seed), str(start + done)],
                env={**os.environ, "TPM_FUZZ_CHILD": "1"},
                capture_output=True, text=True,
            )
            sys.stdout.write(r.stdout)
            sys.stdout.flush()
            if r.returncode != 0:
                sys.stderr.write(r.stderr[-2000:])
                sys.exit(r.returncode)
            res = json.loads(r.stdout.strip().splitlines()[-1])
            events += res["oracle_events_total"]
            wall += res["wall_s"]
            for a, c in res["arm_trials"].items():
                arm_counts[a] = arm_counts.get(a, 0) + c
            done += k
        print(
            json.dumps(
                {
                    "metric": "fuzz_campaign",
                    "trials": n_trials,
                    "master_seed": master_seed,
                    "mismatches": 0,
                    "oracle_events_total": int(events),
                    "arm_trials": arm_counts,
                    "wall_s": round(time.time() - t0, 1),
                }
            )
        )
        return
    arm_counts = {}
    events = 0
    for trial in range(start, start + n_trials):
        res = run_trial(trial, master_seed)
        events += res["events"]
        for a in res["arms"]:
            arm_counts[a] = arm_counts.get(a, 0) + 1
        print(".", end="", flush=True)
        if (trial + 1) % 50 == 0:
            print(f" {trial + 1}", flush=True)
    print()
    print(
        json.dumps(
            {
                "metric": "fuzz_campaign",
                "trials": n_trials,
                "master_seed": master_seed,
                "mismatches": 0,
                "oracle_events_total": events,
                "arm_trials": arm_counts,
                "wall_s": round(time.time() - t0, 1),
            }
        )
    )


if __name__ == "__main__":
    main()
