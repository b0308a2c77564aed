"""The shipped runner (python -m ocean_bgc.run_model) end to end:
constant and time-varying forcing, env cache on/off, health counters."""

import json
import os

import numpy as np

import ocean_bgc  # noqa: F401
import jax.numpy as jnp

from ocean_bgc.models.forcing_series import (
    save_forcing_series,
    stack_forcings,
)
from ocean_bgc.run_model import main
from ocean_bgc.utils.synthetic import synthetic_world


def _run(capsys, argv):
    rc = main(argv)
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_cli_constant_forcing_health(tmp_path, capsys):
    summary = _run(capsys, [
        "--steps", "3", "--nlev", "4", "--ncol", "6", "--quiet",
        "--health", "--out", str(tmp_path)])
    assert summary["finite"]
    assert summary["health_solver_nonconverged_cells_total"] == 0.0
    assert summary["health_poc_error_cells_total"] == 0.0
    assert os.path.exists(summary["final_checkpoint"])


def test_cli_env_cache_off_matches_reference_semantics(tmp_path, capsys):
    a = _run(capsys, ["--steps", "2", "--nlev", "4", "--ncol", "6",
                      "--quiet", "--out", str(tmp_path / "a")])
    b = _run(capsys, ["--steps", "2", "--nlev", "4", "--ncol", "6",
                      "--quiet", "--no-env-cache",
                      "--out", str(tmp_path / "b")])
    # same physics either way (ulp-equivalence is pinned elsewhere;
    # here: both run and close their budgets)
    assert a["finite"] and b["finite"]
    assert abs(a["max_abs_Jint_Ctot"]) < 1e-10
    assert abs(b["max_abs_Jint_Ctot"]) < 1e-10


def test_cli_forcing_series_hold(tmp_path, capsys):
    worlds = [synthetic_world(nlev=4, ncol=6, seed=500 + r)
              for r in range(3)]
    series = stack_forcings([w[2] for w in worlds])
    path = str(tmp_path / "series.nc")
    save_forcing_series(path, series, record_dt=2 * 3600.0)

    summary = _run(capsys, [
        "--steps", "4", "--nlev", "4", "--ncol", "6", "--quiet",
        "--forcing-series", path, "--interp", "hold", "--health",
        "--out", str(tmp_path / "run")])
    assert summary["finite"]
    assert summary["health_solver_nonconverged_cells_total"] == 0.0


def test_cli_forcing_series_linear(tmp_path, capsys):
    worlds = [synthetic_world(nlev=4, ncol=6, seed=600 + r)
              for r in range(2)]
    series = stack_forcings([w[2] for w in worlds])
    path = str(tmp_path / "series.nc")
    save_forcing_series(path, series, record_dt=2 * 3600.0)
    summary = _run(capsys, [
        "--steps", "3", "--nlev", "4", "--ncol", "6", "--quiet",
        "--forcing-series", path, "--interp", "linear",
        "--out", str(tmp_path / "run")])
    assert summary["finite"]


def test_cli_history_fields_filter(tmp_path, capsys):
    """--history-fields writes history containing exactly the requested
    diagnostics (the selective-diagnostics production configuration)."""
    summary = _run(capsys, [
        "--steps", "4", "--nlev", "4", "--ncol", "6", "--quiet",
        "--history-every", "2", "--out", str(tmp_path),
        "--history-fields", "pco2surf,NITRIF,Jint_Ctot"])
    assert summary["steps"] == 4
    hists = sorted(tmp_path.glob("hist_*.npz"))
    assert hists, list(tmp_path.iterdir())
    import numpy as np
    with np.load(hists[-1]) as f:
        fields = {k for k in f.files
                  if not k.startswith("__") and k != "count"}
    assert fields == {"pco2surf", "NITRIF", "Jint_Ctot"}, fields
