"""On-card smoke run of the matcher's served path.

Drives the antivirus-scan regime (the reference's ClamAV configuration with
``-m 12``) through the CLI entry point at a size users really scan: 15,000
hex signatures truncated to 12 bytes over 8 files of 32 MiB with about
20,000 planted occurrences. Every phase compares its full event set
``(file, offset, pattern)`` exactly with the native C++ oracle; the probe
is compared bit for bit with the NumPy model. All of it is integer work,
so every comparison is exact equality with no tolerance.

    python chip_smoke.py           one GPU: phases a-g
    python chip_smoke.py --four    four GPUs: the multi-device paths only

Phases on one card:
  a  --engine dense (the default engine)
  b  --engine bloom, host verify with on-device exact-gram refinement
  c  --engine bloom --verify device
  d  --engine bloom --pat-shards 2
  e  --ushort on generated flows (dense and bloom)
  f  the probe at 4096 lanes x (4096+halo) rows against the NumPy model,
     plus device-only timings of the probe and the dense walk
  g  pytest -m gpu tests/test_gpu_hardware.py, in this process

Timings are smoke timings, not benchmark cells: each phase prints its wall
time, the compile time inside it (JAX's own compile events), bytes/s over
the scan with compile time taken out, and the process's device-memory peak
so far. Without a GPU the script exits non-zero and prints no result. The
last line of stdout is the JSON result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "smoke_work")
BYTES_DIR = os.path.join(WORK, "bytes")
FLOWS_DIR = os.path.join(WORK, "flows")
N_SIGS, SIG_LEN = 15_000, 12
N_FILES, FILE_MIB, N_PLANTS = 8, 32, 20_000
CLI_ARGS = ["-x", "-m", "12", "-v", "--json-stats", "-B", "4096", "-G", "4096"]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

BYTE_EVENT = re.compile(
    r"^Pattern (\d+) \('[^']*'\) found in file '(.*)' at offset (\d+) \["
)
USHORT_EVENT = re.compile(
    r"^Pattern (\d+) \('[^']*'\) found in file '(.*)' at sequence offset "
    r"(\d+) \["
)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()


# ------------------------------------------------------------- workload


def fresh_dir(path: str) -> None:
    """An empty directory: the CLI scans every file in it."""
    import shutil

    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)


def make_corpus(seed: int):
    """Signature file and 8 random files with planted occurrences, all
    from ``seed``. Returns (sig_path, sigs, file paths)."""
    sys.path.insert(0, ROOT)
    from benchmarks.run_configs import _sig_set

    fresh_dir(BYTES_DIR)
    sigs, _src = _sig_set(N_SIGS, seed=4, length=SIG_LEN, limit=SIG_LEN)
    # a first line of only digits would switch the parser to the
    # categorical "ID PATTERN" format
    assert not sigs[0].hex().isdigit()
    sig_path = os.path.join(WORK, "sigs.hex")
    with open(sig_path, "w") as f:
        f.write("".join(s.hex() + "\n" for s in sigs))
    sig_arr = np.frombuffer(b"".join(sigs), np.uint8).reshape(-1, SIG_LEN)
    rng = np.random.default_rng(seed)
    size = FILE_MIB << 20
    per = N_PLANTS // N_FILES
    paths = []
    for i in range(N_FILES):
        buf = rng.integers(0, 256, size, dtype=np.uint8)
        idx = rng.integers(0, len(sigs), per)
        pos = rng.integers(0, size - SIG_LEN, per)
        # a quarter straddle a 4096-byte chunk boundary
        pos[: per // 4] = rng.integers(1, size // 4096, per // 4) * 4096 - 6
        for k in range(SIG_LEN):
            buf[pos + k] = sig_arr[idx, k]
        path = os.path.join(BYTES_DIR, f"corpus_{i}.bin")
        buf.tofile(path)
        paths.append(path)
    return sig_path, sigs, paths


def oracle_events(patterns, paths, alphabet: int = 256, tokens=None):
    """{(file, start offset, pattern index)} from the native oracle."""
    from pattern_matching.core.oracle_native import NativeOracle

    oracle = NativeOracle(patterns, alphabet=alphabet)
    lens = [len(p) for p in patterns]
    events = set()
    for i, path in enumerate(paths):
        data = tokens[i] if tokens is not None else open(path, "rb").read()
        oracle.reset()
        off, pid, total = oracle.match(data, cap=1 << 21)
        assert total == len(off), "oracle capacity exceeded"
        for e, p in zip(off.tolist(), pid.tolist()):
            events.add((path, e - lens[p] + 1, p))
    return events


def make_flows(seed: int):
    """Ushort workload: 2,000 length-train signatures and 8 flows of 1M
    tokens with planted occurrences. Returns (sig_path, seqs, paths,
    token arrays)."""
    fresh_dir(FLOWS_DIR)
    rng = np.random.default_rng(seed + 1)
    seqs = [tuple(int(x) for x in rng.integers(0, 1500, rng.integers(4, 13)))
            for _ in range(2000)]
    sig_path = os.path.join(WORK, "flows.sigs")
    with open(sig_path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f"{','.join(map(str, s))}; {len(s)}; sig{i}\n")
    paths, toks = [], []
    for i in range(N_FILES):
        t = rng.integers(0, 1500, 1 << 20).astype(np.int32)
        for _ in range(250):
            s = seqs[int(rng.integers(len(seqs)))]
            p = int(rng.integers(0, len(t) - len(s)))
            t[p : p + len(s)] = s
        path = os.path.join(FLOWS_DIR, f"flow_{i}.txt")
        with open(path, "w") as f:
            f.write(",".join(map(str, t.tolist())))
        paths.append(path)
        toks.append(t)
    return sig_path, seqs, paths, toks


# --------------------------------------------------------------- phases


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling (its own
    monitoring events), read before and after each phase."""

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_kw):
        if event.startswith("/jax/core/compile/"):
            self.total += duration


def peak_bytes() -> int:
    import jax

    return int(jax.devices()[0].memory_stats().get("peak_bytes_in_use", 0))


def run_cli(argv, clock, pattern):
    """cli.main in this process; returns (event set, stats, wall, compile)."""
    from pattern_matching import cli

    out = io.StringIO()
    c0, t0 = clock.total, time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli exited {rc}: {argv}")
    lines = out.getvalue().split("\n")
    events = [(m.group(2), int(m.group(3)), int(m.group(1)))
              for m in map(pattern.match, lines) if m]
    stats = json.loads([ln for ln in lines if ln.startswith("{")][-1])
    return set(events), len(events), stats, wall, clock.total - c0


def check_phase(name, argv, want, clock, pattern=BYTE_EVENT, runs=2):
    """Run one CLI phase twice: the first run compiles (its compile time
    is reported), the second is the warm scan the bytes/s come from. Both
    runs must reproduce the oracle's event set exactly. ``runs=1`` keeps
    the cold run only."""
    done = []
    for _ in range(runs):
        got, n_lines, stats, wall, comp = run_cli(argv, clock, pattern)
        missing, extra = len(want - got), len(got - want)
        if missing or extra or n_lines != len(got):
            raise AssertionError(
                f"phase {name}: {len(got)} events vs oracle {len(want)} "
                f"(missing {missing}, extra {extra}, duplicate lines "
                f"{n_lines - len(got)})"
            )
        done.append((wall, comp, stats["wall_us"] / 1e6, stats["bytes"]))
    (cold, comp, _, _), (last, _, scan_s, nbytes) = done[0], done[-1]
    tag = "warm" if runs > 1 else "same (cold) run"
    log(f"phase {name}: ok, {len(want)} events equal the oracle's; cold "
        f"wall {cold:.3f} s of which compile {comp:.3f} s; {tag}: wall "
        f"{last:.3f} s, scan loop {scan_s:.3f} s = {nbytes / scan_s:.4g} "
        f"bytes/s; peak_bytes_in_use {peak_bytes()}")


def _probe_model():
    """The NumPy probe model of tests/test_bloom_kernel_variants.py,
    loaded by path (an installed package may own the name ``tests``)."""
    import importlib.util

    path = os.path.join(ROOT, "tests", "test_bloom_kernel_variants.py")
    spec = importlib.util.spec_from_file_location("probe_model", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.np_probe_model


def phase_probe(bloom_path, table, clock):
    """(f) the probe compiled for the card against the NumPy model at
    4096 lanes x (4096+halo) rows, then device-only timings."""
    import jax
    import jax.numpy as jnp

    from pattern_matching.engine import best_scan_total_fn
    from pattern_matching.ops.bloom import BloomFilterTable, _hits_jit
    from pattern_matching.utils.common import pad_halo
    np_probe_model = _probe_model()

    bft = BloomFilterTable.load(bloom_path)
    cfg = bft.cfg
    C, B = 4096, 4096
    halo = pad_halo(table.max_pat_len - 1, B)
    T = halo + B
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (C, T), dtype=np.uint8)
    pats = [p.symbols for p in table.patterns]
    for ln in range(0, C, 3):
        p = pats[int(rng.integers(len(pats)))]
        at = int(rng.integers(halo, T - len(p)))
        data[ln, at : at + len(p)] = p
    bounds = np.stack([np.full(C, halo, np.int32), np.full(C, T, np.int32)])
    d_data, d_bounds = jax.device_put(data), jax.device_put(bounds)
    words = jax.device_put(bft.words)
    c0 = clock.total
    total, bits = _hits_jit(d_data, d_bounds, words, cfg=cfg)
    bits = np.asarray(bits)
    comp = clock.total - c0
    want = np_probe_model(data, bounds, bft.words, cfg)
    if not np.array_equal(bits, want):
        raise AssertionError(
            f"phase f: probe bitmap differs from the model in "
            f"{int(np.count_nonzero(bits != want))} words"
        )
    log(f"phase f: ok, probe {cfg} bitmap {bits.shape} equals the NumPy "
        f"model bit for bit ({int(total[0])} survivors; integer-exact, no "
        f"tolerance), compile {comp:.3f} s")

    def med_time(fn, n=20):
        jax.block_until_ready(fn())
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    size = C * T
    t_probe = med_time(lambda: _hits_jit(d_data, d_bounds, words, cfg=cfg))
    bytes_moved = size + bits.size * 4
    log(f"phase f: probe alone {t_probe * 1e6:.1f} us per batch = "
        f"{size / t_probe:.4g} input bytes/s, "
        f"{bytes_moved / t_probe / HBM_BYTES_PER_S:.4f} of the 3.35 TB/s "
        f"HBM bound")
    dense_total, _ = best_scan_total_fn(table, C, B, engine="dense")
    dense = jax.jit(dense_total)
    st = jnp.asarray(bounds[0])
    en = jnp.asarray(bounds[1])
    t_dense = med_time(lambda: dense(d_data, st, en))
    log(f"phase f: dense walk alone {t_dense * 1e6:.1f} us per batch = "
        f"{size / t_dense:.4g} input bytes/s; peak_bytes_in_use "
        f"{peak_bytes()}")


def phase_pytest():
    """(g) the card's pytest marker, in this process: every test must
    run and pass (a skip here would mean the card was not seen)."""
    import pytest

    class Count:
        passed = skipped = failed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.skipped:
                self.skipped += 1
            elif report.failed:
                self.failed += 1

    os.environ["TPM_TEST_GPU"] = "1"
    count = Count()
    t0 = time.perf_counter()
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider",
         os.path.join(ROOT, "tests", "test_gpu_hardware.py")],
        plugins=[count],
    )
    if rc != 0 or count.skipped or count.failed or not count.passed:
        raise AssertionError(
            f"phase g: pytest rc {rc}, {count.passed} passed, "
            f"{count.skipped} skipped, {count.failed} failed"
        )
    log(f"phase g: ok, {count.passed} gpu tests passed in "
        f"{time.perf_counter() - t0:.3f} s")


def require_gpus(n: int):
    import jax

    devs = jax.devices()
    d = devs[0]
    log(f"jax: platform {d.platform}, device_kind {d.device_kind}, "
        f"{len(devs)} devices")
    if d.platform != "gpu" or len(devs) < n:
        sys.exit(f"needs {n} GPU(s); JAX found {len(devs)} {d.platform} "
                 f"device(s)")
    return d, len(devs)


def one_card(args):
    from pattern_matching.utils.common import enable_compile_cache

    enable_compile_cache()
    dev, _ = require_gpus(1)
    clock = CompileClock()
    t0 = time.perf_counter()
    sig_path, sigs, paths = make_corpus(args.seed)
    want = oracle_events(sigs, paths)
    log(f"setup: {len(sigs)} signatures, {N_FILES} x {FILE_MIB} MiB, "
        f"{len(want)} oracle events, {time.perf_counter() - t0:.3f} s")
    base = ["-f", BYTES_DIR, "-p", sig_path] + CLI_ARGS
    bloom_path = os.path.join(WORK, "bloom15k.npz")
    check_phase("a dense", base + ["--engine", "dense"], want, clock)
    check_phase("b bloom host verify", base + [
        "--engine", "bloom", "--verify", "host", "--save-bloom", bloom_path,
    ], want, clock)
    check_phase("c bloom device verify",
                base + ["--engine", "bloom", "--verify", "device"],
                want, clock)
    check_phase("d bloom pat-shards 2",
                base + ["--engine", "bloom", "--pat-shards", "2"],
                want, clock)

    usig, seqs, fpaths, toks = make_flows(args.seed)
    uwant = oracle_events(seqs, fpaths, 2048, toks)
    ubase = ["-f", FLOWS_DIR, "-p", usig, "--ushort", "-v", "--json-stats",
             "-B", "4096", "-G", "4096"]
    for engine in ("dense", "bloom"):
        check_phase(f"e ushort {engine}", ubase + ["--engine", engine],
                    uwant, clock, USHORT_EVENT)

    from pattern_matching.core.dfa import compile_patterns

    phase_probe(bloom_path, compile_patterns(sigs), clock)
    phase_pytest()
    return dev, 1


def four_cards(args):
    """The multi-device paths on 4 cards, each against the oracle. The
    4-process run goes first, while this process is still off JAX; the
    oracle runs beside it (native code, outside the interpreter lock)."""
    import concurrent.futures

    t0 = time.perf_counter()
    sig_path, sigs, paths = make_corpus(args.seed)
    log(f"setup: corpus written, {time.perf_counter() - t0:.3f} s")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        oracle = pool.submit(oracle_events, sigs, paths)
        got, wall = run_processes(sig_path)
        want = oracle.result()
    if got != want:
        raise AssertionError(
            f"4-process CLI: {len(got)} events vs oracle {len(want)}"
        )
    log(f"phase 4-process CLI (one card per process): ok, {len(got)} "
        f"events equal the oracle's; wall {wall:.3f} s")

    from pattern_matching.utils.common import enable_compile_cache

    enable_compile_cache()
    dev, count = require_gpus(4)
    clock = CompileClock()
    base = ["-f", BYTES_DIR, "-p", sig_path] + CLI_ARGS + ["--mesh", "4"]
    for name, extra in (
        ("dense", ["--engine", "dense"]),
        ("bloom host verify", ["--engine", "bloom", "--verify", "host"]),
        ("bloom device verify", ["--engine", "bloom", "--verify", "device"]),
        ("pat-shards 2 (2x2 pat,data grid)",
         ["--engine", "bloom", "--pat-shards", "2"]),
    ):
        check_phase(f"mesh 4 {name}", base + extra, want, clock, runs=1)
    phase_group_counts(sigs, paths[0], clock)
    return dev, count


def run_processes(sig_path, timeout: float = 120.0):
    """The CLI as 4 processes on one host, one card each, joined through
    a localhost coordinator. Each child writes to its own file: a pipe
    that filled while its reader waited on another child would stall
    that child, and with it every other one at the next collective."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    argv = ["-f", BYTES_DIR, "-p", sig_path] + CLI_ARGS + [
        "--coordinator", f"localhost:{port}", "--num-processes", "4"]
    t0 = time.perf_counter()
    procs, outs = [], []
    try:
        for i in range(4):
            out = open(os.path.join(WORK, f"proc{i}.out"), "w+")
            outs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pattern_matching.cli"] + argv + [
                    "--process-id", str(i), "--local-devices", str(i)],
                cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
            ))
        for i, p in enumerate(procs):
            rc = p.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            if rc != 0:
                outs[i].seek(0)
                raise RuntimeError(f"4-process CLI: process {i} exited {rc}:"
                                   f"\n{outs[i].read()[-3000:]}")
        wall = time.perf_counter() - t0
        got = set()
        for out in outs:
            out.seek(0)
            got.update((m.group(2), int(m.group(3)), int(m.group(1)))
                       for m in map(BYTE_EVENT.match, out.read().split("\n"))
                       if m)
        return got, wall
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out in outs:
            out.close()


def phase_group_counts(sigs, path, clock):
    """The psum group-count step over 4 cards on one 16 MiB batch: the
    global counts must sum to the oracle's distinct match ends."""
    import jax

    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.core.oracle_native import NativeOracle
    from pattern_matching.ops.table import DeviceTable
    from pattern_matching.parallel.mesh import (
        MeshContext,
        make_mesh,
        make_sharded_scan_step,
    )
    from pattern_matching.runtime.buffers import DataBuffer, StreamState
    from pattern_matching.utils.common import pad_halo

    table = compile_patterns(sigs)
    C, B = 4096, 4096
    data = open(path, "rb").read()[: C * B]
    halo = pad_halo(table.max_pat_len - 1, B)
    buf = DataBuffer(C, B, halo)
    buf.add_stream(io.BytesIO(data), StreamState(file_id=0))
    batch = buf.to_batch()
    assert buf.bytes == len(data)
    ctx = MeshContext(make_mesh(jax.devices()[:4]))
    dev = DeviceTable.put(table, ctx.replicated)
    step = make_sharded_scan_step(ctx, dev, halo=halo, max_results=16,
                                  num_groups=table.num_groups)
    c0, t0 = clock.total, time.perf_counter()
    out = step(dev.table_flat, dev.state_gid,
               jax.device_put(batch.data, ctx.lane_sharded),
               batch.start_t, batch.end_t)
    got = int(np.asarray(out[3]).sum())
    wall = time.perf_counter() - t0
    off, _pid, total = NativeOracle(sigs).match(data, cap=1 << 21)
    assert total == len(off)
    want = len(set(off.tolist()))
    if got != want:
        raise AssertionError(f"group counts sum {got} vs oracle {want}")
    log(f"phase psum group counts: ok, {got} ends equal the oracle's; "
        f"wall {wall:.3f} s, compile {clock.total - c0:.3f} s, "
        f"peak_bytes_in_use {peak_bytes()}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device paths, on 4 GPUs")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t0 = time.perf_counter()
    smi = nvidia_smi()
    for line in smi:
        log(f"nvidia-smi: {line}")
    dev, count = (four_cards if args.four else one_card)(args)
    log(f"all phases ok in {time.perf_counter() - t0:.3f} s")
    for line in smi:
        log(line)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
