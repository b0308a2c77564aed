"""Run the full test suite in several short-lived pytest processes.

Why: this image's XLA:CPU backend ships AOT kernels compiled for a
different host (the cpu_aot_loader feature-mismatch warnings at import,
"could lead to execution errors such as SIGILL"), and long-lived suite
processes nondeterministically segfault inside LLVM during a LATE
`backend_compile_and_load` (one such crash killed a full-suite run
inside test_run_model_cli.py, green standalone).  Nothing in the repo controls the image's jax
wheels, so the suite-level mitigation is structural: bound every pytest
process's lifetime by splitting the files into chunks, each run in its
own interpreter.  A crashed chunk reports its files so the flake is
attributable.

Usage:
    python scripts/run_suite.py [--chunks N] [-- extra pytest args]

Exit code 0 iff every chunk passes.

BUDGET: the full suite measured ~3,200-3,800 s green on this image
(round 4: 3,225 s; the deep-world/adjoint files alone are ~1,700 s,
dominated by XLA CPU compiles).  Fast-fail ordering: the known
compile-heavy files are pinned to the LAST chunk so cheap chunks
surface failures in the first few hundred seconds; if the runner must
fit a tighter window, pass more --chunks (smaller processes) or run
the expensive chunk separately.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=6,
                    help="number of pytest processes")
    ap.add_argument("--parallel", type=int, default=1,
                    help="run up to N chunks concurrently (default 1 — "
                         "the documented sequential behavior; 2 cuts "
                         "the ~1h wall time substantially on this "
                         "many-core host at the cost of interleaved "
                         "output)")
    ap.add_argument("--files", nargs="*",
                    help="restrict to these test files (basenames) — "
                         "for smoke-testing the runner itself")
    ap.add_argument("rest", nargs="*",
                    help="extra pytest args after --")
    args = ap.parse_args()

    files = sorted(glob.glob(os.path.join(REPO, "tests", "test_*.py")))
    if args.files:
        keep = set(args.files)
        files = [f for f in files if os.path.basename(f) in keep]

    # fast-fail ordering: the measured compile-heavy files (deep world,
    # adjoint, fp32 deep, multiprocess) run in the LAST chunk so a
    # failure anywhere cheap surfaces within the first few hundred
    # seconds of the ~1-hour budget (see module docstring)
    EXPENSIVE = ("test_deep_world.py", "test_adjoint.py",
                 "test_fp32_deep.py", "test_distributed_multiprocess.py")
    slow = [f for f in files if os.path.basename(f) in EXPENSIVE]
    fast = [f for f in files if f not in slow]

    # balance the rest by file size (a cheap proxy for
    # compile-heaviness), round-robin over size-sorted files
    nfast = max(1, args.chunks - 1)
    by_size = sorted(fast, key=os.path.getsize, reverse=True)
    chunks = [[] for _ in range(nfast)]
    for i, f in enumerate(by_size):
        chunks[i % nfast].append(f)
    chunks.append(slow)

    failures = []
    t0 = time.monotonic()
    todo = [(i, c) for i, c in enumerate(c for c in chunks if c)]
    running = []

    def reap(block):
        while True:
            finished = [item for item in running
                        if item[2].poll() is not None]
            for item in finished:
                running.remove(item)
                i, names, p = item
                if p.returncode != 0:
                    failures.append((i, names, p.returncode))
                print(f"[chunk {i}] rc={p.returncode} "
                      f"(elapsed {time.monotonic() - t0:.0f}s)",
                      flush=True)
            if finished or not block or not running:
                return
            time.sleep(2.0)

    for i, chunk in todo:
        while len(running) >= max(1, args.parallel):
            reap(block=True)
        names = [os.path.basename(f) for f in chunk]
        print(f"[chunk {i}] {' '.join(names)}", flush=True)
        p = subprocess.Popen(
            [sys.executable, "-m", "pytest", "-q", *args.rest, *chunk],
            cwd=REPO)
        running.append((i, names, p))
    while running:
        reap(block=True)

    if failures:
        print("FAILED chunks:")
        for i, names, rc in failures:
            print(f"  chunk {i} rc={rc}: {' '.join(names)}")
        return 1
    print(f"all chunks green in {time.monotonic() - t0:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
