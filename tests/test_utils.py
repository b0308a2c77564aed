"""Checkpoint round-trip, config overrides, diagnostics registry."""

import dataclasses
import os

import numpy as np
import pytest

import ocean_bgc  # noqa: F401

from ocean_bgc.models.coupled import step
from ocean_bgc.params import ModelParams
from ocean_bgc.utils import checkpoint as ckpt
from ocean_bgc.utils.config import (params_from_dict, params_from_toml,
                                    params_to_dict)
from ocean_bgc.utils.diag import coupled_registry
from ocean_bgc.utils.synthetic import synthetic_world


def test_checkpoint_roundtrip(tmp_path):
    state, grid, forcing = synthetic_world(nlev=6, ncol=8, seed=21)
    s1, _ = step(state, grid, forcing, ModelParams(), 3600.0,
                 compute_diags=False)
    path = ckpt.save(str(tmp_path / "ck"), s1, step=7)
    restored, n = ckpt.restore(path)
    assert n == 7
    np.testing.assert_array_equal(np.asarray(restored.bgc.tracers),
                                  np.asarray(s1.bgc.tracers))
    np.testing.assert_array_equal(np.asarray(restored.bgc.ph_prev_3d),
                                  np.asarray(s1.bgc.ph_prev_3d))
    np.testing.assert_array_equal(np.asarray(restored.dms),
                                  np.asarray(s1.dms))
    # resume: stepping the restored state equals stepping the original
    a, _ = step(s1, grid, forcing, ModelParams(), 3600.0,
                compute_diags=False)
    b, _ = step(restored, grid, forcing, ModelParams(), 3600.0,
                compute_diags=False)
    np.testing.assert_array_equal(np.asarray(a.bgc.tracers),
                                  np.asarray(b.bgc.tracers))


def test_checkpoint_npz_fallback(tmp_path):
    state, _, _ = synthetic_world(nlev=4, ncol=4, seed=22)
    path = ckpt.save(str(tmp_path / "ck_npz"), state, use_orbax=False)
    assert path.endswith(".npz") and os.path.exists(path)
    restored, n = ckpt.restore(path, use_orbax=False)
    assert n is None
    np.testing.assert_array_equal(np.asarray(restored.macros),
                                  np.asarray(state.macros))


def test_config_overrides(tmp_path):
    cfg = tmp_path / "run.toml"
    cfg.write_text(
        """
[bgc]
parm_Fe_bioavail = 0.9
lrest_no3 = true
parm_scalelen_vals = [1.0, 2.0, 4.0, 8.0]

[autotroph.sp]
PCref_per_day = 6.0

[dms]
k_S_B_per_day = 25.0

[macros]
f_prot = 0.5
""")
    params = params_from_toml(str(cfg))
    assert params.bgc.parm_Fe_bioavail == 0.9
    assert params.bgc.lrest_no3 is True
    assert params.bgc.parm_scalelen_vals == (1.0, 2.0, 4.0, 8.0)
    np.testing.assert_allclose(params.bgc.autotrophs[0].PCref,
                               6.0 / 86400.0, rtol=1e-15)
    # untouched groups keep defaults
    np.testing.assert_allclose(params.bgc.autotrophs[1].PCref,
                               5.5 / 86400.0, rtol=1e-15)
    np.testing.assert_allclose(params.dms.k_S_B, 25.0 / 86400.0, rtol=1e-15)
    assert params.macros.f_prot == 0.5


def test_config_rejects_unknown_keys():
    with pytest.raises(KeyError):
        params_from_dict({"bgc": {"not_a_param": 1.0}})
    with pytest.raises(KeyError):
        params_from_dict({"autotroph": {"krill": {"PCref": 1.0}}})


def test_config_roundtrip():
    params = params_from_dict(params_to_dict(ModelParams()))
    assert params == ModelParams()


def test_diag_registry_covers_all_emitted_fields():
    state, grid, forcing = synthetic_world(nlev=5, ncol=6, seed=23)
    _, diags = step(state, grid, forcing, ModelParams(), 3600.0,
                    compute_diags=True)
    registry = coupled_registry()
    missing = set(diags) - set(registry)
    assert not missing, f"unregistered diagnostics: {sorted(missing)}"
    # shape kinds are accurate
    nlev, ncol, nauto = 5, 6, 4
    shapes = {"level": (nlev, ncol), "level_auto": (nlev, nauto, ncol),
              "column": (ncol,), "column_auto": (nauto, ncol),
              "tracer": (30, ncol)}
    for name, arr in diags.items():
        want = shapes[registry[name].kind]
        assert tuple(arr.shape) == want, (name, arr.shape, want)


def test_checkpoint_sharded_restore_single_process(tmp_path, rng):
    """restore(path, mesh=...) on the virtual 8-device mesh: the state
    comes back sharded over the columns mesh (no single-host
    materialization path) and bitwise-equal; the npz path refuses
    nothing here (fully addressable) but the orbax mesh path must
    round-trip with correct shardings."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ocean_bgc.parallel import make_mesh, shard_world
    from ocean_bgc.utils import checkpoint as ckpt
    from ocean_bgc.utils.synthetic import synthetic_world

    state, grid, forcing = synthetic_world(nlev=4, ncol=16, seed=11)
    mesh = make_mesh()
    state, grid, forcing = shard_world(state, grid, forcing, mesh)
    path = ckpt.save(str(tmp_path / "ck"), state, step=5,
                     use_orbax=True)
    restored, n = ckpt.restore(path, mesh=mesh)
    assert n == 5
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
        # columns axis sharded, rest replicated
        assert isinstance(b.sharding, NamedSharding)
        want = P(*([None] * (b.ndim - 1) + ["columns"]))
        assert b.sharding.spec == want, (b.shape, b.sharding.spec)


@pytest.mark.parametrize("env_dir", [None, "cache_here"])
def test_compile_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set, and nothing else is
    configured; otherwise the cache sits at <checkout>/.jax_cache."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = repo
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = ("import jax\n"
            "from ocean_bgc.utils.compile_cache import enable_compile_cache\n"
            "print(enable_compile_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       check=True)
    returned, configured = r.stdout.split()
    want = (str(tmp_path / env_dir) if env_dir is not None
            else os.path.join(repo, ".jax_cache"))
    assert returned == configured == want
