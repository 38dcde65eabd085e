"""Scaling-efficiency benchmark: bytes/s at 1..N devices.

BASELINE target: >=80% linear bytes/s scaling 1 -> N. On real multi-GPU
hardware this measures interconnect scaling; by default it runs on the
simulated N-device CPU mesh (``--platform cpu``), which validates the
sharded program and the scaling HARNESS rather than the hardware. The data-parallel scan has no cross-device
communication in its hot loop (table replicated, lanes independent, one [G]
psum per batch), so near-linear scaling is structural.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_multiprocess(args) -> None:
    """The multi-HOST arm: N processes x (devices/N) CPU devices grep the
    same corpus through the real CLI, each host's feeder owning a DISJOINT
    round-robin file subset (input bandwidth scales with hosts). On this
    one-core host the numbers validate the harness
    and the lockstep product path, not the hardware; on real separate hosts the
    same command measures true DCN scaling."""
    import socket
    import subprocess
    import tempfile

    P = args.multiprocess
    dev_per = max(1, args.max_devices // P)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rng = np.random.RandomState(0)
    tmp = tempfile.mkdtemp(prefix="tpm_scale_mp_")
    patfile = os.path.join(tmp, "pats.txt")
    with open(patfile, "wb") as f:
        for _ in range(args.patterns):
            f.write(rng.bytes(12).hex().encode() + b"\n")
    files = []
    for i in range(2 * P):
        p = os.path.join(tmp, f"in{i}.bin")
        with open(p, "wb") as f:
            f.write(rng.bytes(4 << 20))
        files.append(p)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    worker_env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    worker_env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={dev_per}"
    )
    worker_env["JAX_PLATFORMS"] = "cpu"
    code = (
        "import sys, jax; jax.config.update('jax_platforms', 'cpu');"
        "from pattern_matching.cli import main;"
        "sys.exit(main(sys.argv[1:]))"
    )
    cli_args = [
        "-f", ",".join(files), "-p", patfile, "-x",
        "-B", str(args.chunk_len), "-G", str(256 * dev_per), "-w", "2",
        "--engine", "bloom", "--json-stats",
    ]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code] + cli_args
            + ["--coordinator", f"localhost:{port}",
               "--num-processes", str(P), "--process-id", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            cwd=root, env=worker_env,
        )
        for i in range(P)
    ]
    outs = [p.communicate(timeout=1800)[0].decode() for p in procs]
    dt = time.perf_counter() - t0
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"proc {i} failed"
    stats = json.loads(
        [l for l in outs[0].splitlines() if l.startswith("{")][-1]
    )
    print(json.dumps({
        "metric": "scaling_multiprocess",
        "processes": P,
        "devices_per_process": dev_per,
        "bytes": stats["bytes"],
        "wall_s": round(dt, 3),
        "bytes_per_s": stats["bytes"] / dt,
        "matches": stats["matches_total"],
        "note": "CPU-simulated hosts share one core here; the harness and "
                "disjoint-input path are what this validates",
    }))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default="cpu", choices=["cpu", "native"])
    ap.add_argument("--max-devices", type=int, default=8)
    ap.add_argument("--lanes-per-device", type=int, default=256)
    ap.add_argument("--chunk-len", type=int, default=1024)
    ap.add_argument("--patterns", type=int, default=1000)
    ap.add_argument("--engine", default="bloom", choices=["bloom", "dense"])
    ap.add_argument("--multiprocess", type=int, default=0,
                    help="N>0: run the multi-host CLI arm with N processes")
    args = ap.parse_args()

    if args.multiprocess:
        run_multiprocess(args)
        return

    if args.platform == "cpu":
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.max_devices}"
        ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.ops.bloom import BloomFilterTable
    from pattern_matching.ops.table import DeviceTable
    from pattern_matching.parallel.mesh import (
        MeshContext,
        make_mesh,
        make_sharded_bloom_step,
        make_sharded_scan_step,
    )
    from pattern_matching.utils.common import pad_halo

    rng = np.random.RandomState(0)
    pats = [
        bytes(rng.randint(0, 256, size=12).astype(np.uint8))
        for _ in range(args.patterns)
    ]
    table = compile_patterns(pats)
    B = args.chunk_len
    halo = pad_halo(table.max_pat_len - 1, B)

    results = []
    n = 1
    while n <= min(args.max_devices, len(jax.devices())):
        C = args.lanes_per_device * n
        data = rng.randint(0, 256, size=(C, halo + B)).astype(np.uint8)
        start_t = np.full(C, halo, np.int32)
        end_t = np.full(C, halo + B, np.int32)
        ctx = MeshContext(make_mesh(jax.devices()[:n]))
        if args.engine == "bloom":
            bft = BloomFilterTable.from_table(table)
            bloom = bft.put(ctx.replicated)
            bstep = make_sharded_bloom_step(ctx, bloom)
            dsh = jax.device_put(data, ctx.lane_sharded)
            bsh = jax.device_put(
                np.stack([start_t, end_t]), ctx.lane_sharded2d
            )
            run = lambda: bstep(bloom.words, dsh, bsh)
        else:
            dev = DeviceTable.put(table, ctx.replicated)
            step = make_sharded_scan_step(
                ctx, dev, halo=halo, max_results=16,
                num_groups=table.num_groups,
            )
            dsh = jax.device_put(data, ctx.lane_sharded)
            run = lambda: step(dev.table_flat, dev.state_gid, dsh,
                               start_t, end_t)
        jax.block_until_ready(run())
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            out = run()
            jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / iters
        results.append({"devices": n, "bytes_per_s": C * B / dt})
        n *= 2

    base = results[0]["bytes_per_s"]
    for r in results:
        r["efficiency"] = r["bytes_per_s"] / (base * r["devices"])
    print(json.dumps({"metric": "scaling", "platform": args.platform,
                      "engine": args.engine, "results": results}))


if __name__ == "__main__":
    main()
