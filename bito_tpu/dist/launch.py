"""Local multi-process launcher: CPU emulation of a multi-host job.

    python -m bito_tpu.dist.launch -n 2 [--devices-per-process K] \
        [--stall-timeout S] [--hard-timeout S] script.py [args...]

Spawns N copies of script.py, each wired to a shared coordinator via the
BITO_* environment variables that multihost.initialize() reads, with K
virtual CPU devices per process (XLA_FLAGS host platform device count).
Exit status is nonzero if any worker fails; worker output is streamed with
a `[p<i>]` prefix.

Failure diagnosis (a wedged distributed job must die fast and say why):
every output line from any worker counts as a heartbeat; if NO worker
produces output for --stall-timeout seconds (default 120), or the whole
job exceeds --hard-timeout (default none), the launcher kills the exact
worker processes it spawned and exits nonzero with each worker's last
output lines, so the stalled rank is attributable.

This is an emulator only: it always forces JAX_PLATFORMS=cpu.  On a GPU
host, one process drives all of the host's cards through one mesh
(`make_mesh`, then `engine.shard_patterns(mesh)`), so nothing spawns a
process per card.  A real multi-host job starts one process per host
through its cluster scheduler and passes --coordinator/--num-hosts/
--host-id (or the BITO_* env vars) itself; see dist/multihost.py.
"""
from __future__ import annotations

import argparse
import collections
import os
import socket
import subprocess
import sys
import threading
import time


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bito_tpu.dist.launch")
    ap.add_argument("-n", "--num-processes", type=int, required=True)
    ap.add_argument("--devices-per-process", type=int, default=1)
    ap.add_argument("--stall-timeout", type=float, default=120.0,
                    help="seconds without output from ANY worker before "
                         "the job is declared wedged and killed")
    ap.add_argument("--hard-timeout", type=float, default=0.0,
                    help="absolute wall-clock cap (0 = none)")
    ap.add_argument("script")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    port = _free_port()
    procs = []
    for pid in range(args.num_processes):
        env = dict(os.environ)
        env["BITO_COORDINATOR"] = f"localhost:{port}"
        env["BITO_NUM_PROCESSES"] = str(args.num_processes)
        env["BITO_PROCESS_ID"] = str(pid)
        env["JAX_PLATFORMS"] = "cpu"
        flags = env.get("XLA_FLAGS", "")
        env["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count="
            f"{args.devices_per_process}").strip()
        procs.append(subprocess.Popen(
            [sys.executable, args.script] + args.script_args,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ))

    last_output = [time.monotonic()]
    tails = [collections.deque(maxlen=5) for _ in procs]

    def pump(i, p):
        for line in p.stdout:
            last_output[0] = time.monotonic()
            tails[i].append(line.rstrip())
            sys.stdout.write(f"[p{i}] {line}")
            sys.stdout.flush()

    threads = [threading.Thread(target=pump, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()

    start = time.monotonic()

    def _diagnose(reason: str) -> str:
        lines = [f"bito_tpu.dist.launch: {reason}"]
        for i, p in enumerate(procs):
            state = ("running" if p.poll() is None
                     else f"exited {p.returncode}")
            lines.append(f"  worker p{i}: {state}; last output:")
            for ln in tails[i] or ["    <none>"]:
                lines.append(f"    {ln}")
        return "\n".join(lines)

    killed_reason = None
    while any(p.poll() is None for p in procs):
        time.sleep(0.25)
        now = time.monotonic()
        if args.stall_timeout and now - last_output[0] > args.stall_timeout:
            killed_reason = (f"no worker output for "
                             f"{args.stall_timeout:.0f}s — wedged")
            break
        if args.hard_timeout and now - start > args.hard_timeout:
            killed_reason = f"exceeded hard timeout {args.hard_timeout:.0f}s"
            break

    if killed_reason is not None:
        diag = _diagnose(killed_reason)
        # Kill the exact processes this launcher spawned (never patterns).
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for t in threads:
            t.join(timeout=2)
        sys.exit(diag)

    codes = [p.wait() for p in procs]
    for t in threads:
        t.join(timeout=2)
    if any(codes):
        sys.exit(_diagnose(f"workers exited with {codes}"))


if __name__ == "__main__":
    main()
