"""chip_smoke.py refuses to run without a GPU: it exits non-zero before
any compile and prints no result line."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=120,
                       cwd=REPO)
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    assert '"ok"' not in r.stdout
    assert "phase" not in r.stdout
