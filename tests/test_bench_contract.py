"""The output contract of bench.py.

The default run emits exactly ONE parseable JSON line with the
metric-contract fields and no quad configs, and the wall-clock budget
(measured from process start) skips the CPU baseline instead of
risking the artifact.

Runs bench.py as a subprocess, on CPU with tiny shapes so the whole
test costs seconds of compile.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_bench(extra_env):
    # strip ambient BENCH_* vars (a shell with BENCH_QUAD=1 etc. left
    # over from a benchmarking session must not flip these assertions)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_")}
    env.update(BENCH_PLATFORM="cpu", BENCH_NCOL="32", BENCH_NLEV="4",
               BENCH_STEPS="2", BENCH_REPEATS="1", **extra_env)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    json_lines = [ln for ln in r.stdout.splitlines()
                  if ln.startswith("{")]
    assert len(json_lines) == 1, r.stdout
    return json.loads(json_lines[0])


def test_default_invocation_single_line_no_quad():
    out = _run_bench({})
    assert out["metric"].startswith("columns_per_s_per_chip")
    for field in ("value", "unit", "vs_baseline", "env", "diags",
                  "baseline"):
        assert field in out, field
    assert out["value"] > 0
    # the quad must be OPT-IN: each config is one more compile
    assert "configs" not in out


def test_budget_exhaustion_falls_back_to_pinned_baseline():
    out = _run_bench({"BENCH_BUDGET_S": "0"})
    # the primary measurement still lands (it IS the artifact) ...
    assert out["value"] > 0
    # ... and with no live CPU baseline there is no ratio
    assert out["vs_baseline"] is None
    assert "skipped" in out["baseline"]
