"""Dependency-free NetCDF-3 layer + the world/restart file bridge."""

import os

import numpy as np
import pytest

import ocean_bgc  # noqa: F401
import jax
import jax.numpy as jnp

from ocean_bgc.io import netcdf3 as nc
from ocean_bgc.io.model_io import (load_world, save_history_netcdf,
                                   save_world)
from ocean_bgc.models.coupled import step
from ocean_bgc.params import ModelParams
from ocean_bgc.utils.synthetic import synthetic_world


def test_netcdf3_round_trip(tmp_path, rng):
    ds = nc.Dataset()
    ds.dims = {"time": 0, "nlev": 5, "ncol": 7}
    ds.record_dim = "time"
    ds.attrs = {"title": "t", "version": np.int32(3), "pi": 3.14159}
    ds.variables["temp"] = nc.Variable(
        ("nlev", "ncol"), rng.normal(size=(5, 7)), {"units": "C"})
    ds.variables["salt32"] = nc.Variable(
        ("nlev", "ncol"), rng.normal(size=(5, 7)).astype(np.float32), {})
    ds.variables["kmax"] = nc.Variable(
        ("ncol",), np.arange(7, dtype=np.int32), {})
    ds.variables["sst"] = nc.Variable(
        ("time", "ncol"), rng.normal(size=(3, 7)), {})
    ds.variables["steps"] = nc.Variable(
        ("time",), np.arange(3, dtype=np.int32), {})

    p = os.path.join(tmp_path, "t.nc")
    nc.write(p, ds)
    back = nc.read(p)

    assert back.dims == {"time": 3, "nlev": 5, "ncol": 7}
    assert back.record_dim == "time"
    assert back.attrs["title"] == "t"
    assert float(back.attrs["pi"]) == pytest.approx(3.14159)
    for name, v in ds.variables.items():
        got = back.variables[name]
        assert got.dims == v.dims
        assert got.data.dtype == v.data.dtype.newbyteorder("=")
        np.testing.assert_array_equal(got.data, v.data)
    assert back.variables["temp"].attrs["units"] == "C"


def test_netcdf3_scipy_interop(tmp_path, rng):
    scipy_io = pytest.importorskip("scipy.io")
    # ours -> scipy
    ds = nc.Dataset()
    ds.dims = {"x": 6, "time": 0}
    ds.record_dim = "time"
    vals = rng.normal(size=6)
    recs = rng.normal(size=(4, 6)).astype(np.float32)
    ds.variables["vals"] = nc.Variable(("x",), vals, {})
    ds.variables["recs"] = nc.Variable(("time", "x"), recs, {})
    p = os.path.join(tmp_path, "ours.nc")
    nc.write(p, ds)
    f = scipy_io.netcdf_file(p, "r", mmap=False)
    np.testing.assert_array_equal(f.variables["vals"][:], vals)
    np.testing.assert_array_equal(f.variables["recs"][:], recs)
    f.close()
    # scipy -> ours
    p2 = os.path.join(tmp_path, "scipy.nc")
    g = scipy_io.netcdf_file(p2, "w")
    g.createDimension("x", 6)
    v = g.createVariable("vals", "f8", ("x",))
    v[:] = vals
    g.history = "scipy"
    g.flush()
    g.close()
    back = nc.read(p2)
    np.testing.assert_array_equal(back.variables["vals"].data, vals)
    assert back.attrs["history"] == "scipy"


def test_world_file_round_trip_and_step(tmp_path):
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=6, ncol=9, seed=5)
    p = os.path.join(tmp_path, "world.nc")
    save_world(p, state, grid, forcing, attrs={"experiment": "unit"})

    state2, grid2, forcing2 = load_world(p)
    for a, b in zip(jax.tree.leaves((state, grid, forcing)),
                    jax.tree.leaves((state2, grid2, forcing2))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # the reloaded world steps to the identical state (restart contract)
    out1, _ = step(state, grid, forcing, params, 3600.0,
                   compute_diags=False)
    out2, _ = step(state2, grid2, forcing2, params, 3600.0,
                   compute_diags=False)
    np.testing.assert_array_equal(np.asarray(out1.bgc.tracers),
                                  np.asarray(out2.bgc.tracers))


def test_world_file_f32_cast(tmp_path):
    state, grid, forcing = synthetic_world(nlev=4, ncol=5, seed=6)
    p = os.path.join(tmp_path, "world.nc")
    save_world(p, state, grid, forcing)
    state2, grid2, _ = load_world(p, dtype=jnp.float32)
    assert state2.bgc.tracers.dtype == jnp.float32
    assert grid2.kmax.dtype == jnp.int32


def test_history_netcdf(tmp_path):
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=4, ncol=5, seed=7)
    _, diags = step(state, grid, forcing, params, 3600.0,
                    compute_diags=True)
    means = {k: np.asarray(v) for k, v in diags.items()
             if k in ("PH_3D", "O2_PRODUCTION", "pCO2")
             or np.asarray(v).ndim in (1, 2)}
    p = os.path.join(tmp_path, "hist.nc")
    save_history_netcdf(p, means, nlev=4, ncol=5, count=1)
    back = nc.read(p)
    for k, v in means.items():
        np.testing.assert_allclose(back.variables[k].data, v)
    # registry metadata attached where known
    assert any("units" in v.attrs for v in back.variables.values())
