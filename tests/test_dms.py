"""DMS kernel vs the scalar oracle (exercises the PAR scan carry)."""

import numpy as np

import ocean_bgc  # noqa: F401
import jax.numpy as jnp

from ocean_bgc.ops.dms import dms_source_sink
from ocean_bgc.params import DMSParams
from ocean_bgc.state import DMSTracers as DT
from tests.oracle import trace_gas_ref as ref


def _setup(rng, nlev=20, ncol=33):
    tracers = rng.uniform(0.0, 2.0, (nlev, DT.CNT, ncol))
    tracers[:, DT.DMS] *= 0.01
    tracers[:, DT.DMSP] *= 0.01
    tracers[2, :, 1] = -1.0                      # clip path
    dz = rng.uniform(500.0, 2000.0, (nlev, ncol))   # cm
    kmax = rng.integers(1, nlev + 1, ncol)
    kmax[0] = 0                                  # a land column
    kmax[ncol - 1] = nlev
    sst = rng.uniform(-1.8, 30.0, ncol)
    sst[1] = 0.5     # cryoprotection window
    sst[2] = -1.5    # deep-cold override
    sst[3] = 17.0    # mid fuzzy-interp range
    sw = rng.uniform(0.0, 350.0, ncol)
    return tracers, dz, kmax, sst, sw


def test_dms_matches_oracle(rng):
    tracers, dz, kmax, sst, sw = _setup(rng)
    params = DMSParams()
    nlev, ncol = tracers.shape[0], tracers.shape[2]
    active = np.arange(nlev)[:, None] < kmax[None, :]
    tend, diags = dms_source_sink(
        jnp.asarray(tracers), jnp.asarray(dz), jnp.asarray(active),
        jnp.asarray(sst), jnp.asarray(sw), params)
    want_tend, want_diags = ref.dms_source_sink(tracers, dz, kmax, sst, sw,
                                                params)
    np.testing.assert_allclose(np.asarray(tend), want_tend, rtol=1e-12,
                               atol=1e-22)
    np.testing.assert_allclose(np.asarray(diags["phytoN"]),
                               want_diags["phytoN"], rtol=1e-13, atol=1e-22)
    np.testing.assert_allclose(np.asarray(diags["zooS"]),
                               want_diags["zooS"], rtol=1e-12, atol=1e-22)


def test_dms_ragged_matches_oracle(rng):
    """Directed raggedness pin: the reference's k-loop stops at the ocean
    floor (``do k = 1, kmax``, DMS_mod.F90:516), while the batched kernel
    attenuates PAR with an UNMASKED cumulative product over all nlev
    levels (ops/dms.py).  Fill the sub-floor cells with extreme
    chlorophyll/DOC so that, if the unmasked cumprod could influence any
    active cell, the mismatch would be enormous — then pin the full
    tendency and diagnostic fields against the floor-stopping scalar
    oracle at near-bitwise tolerance."""
    tracers, dz, kmax, sst, sw = _setup(rng, nlev=24, ncol=17)
    nlev, ncol = tracers.shape[0], tracers.shape[2]
    below = np.arange(nlev)[:, None] >= kmax[None, :]
    # poison every sub-floor cell: opaque chlorophyll, huge DOC/DMSP
    poisoned = tracers.copy()
    poisoned[:, DT.SPCHL][below] = 1.0e4
    poisoned[:, DT.DIATCHL][below] = 1.0e4
    poisoned[:, DT.DOC][below] = 1.0e6
    poisoned[:, DT.DMSP][below] = 1.0e5
    params = DMSParams()
    active = ~below
    tend, diags = dms_source_sink(
        jnp.asarray(poisoned), jnp.asarray(dz), jnp.asarray(active),
        jnp.asarray(sst), jnp.asarray(sw), params)
    want_tend, want_diags = ref.dms_source_sink(poisoned, dz, kmax, sst,
                                                sw, params)
    np.testing.assert_allclose(np.asarray(tend), want_tend, rtol=1e-12,
                               atol=1e-22)
    for k in want_diags:
        if k in diags:
            np.testing.assert_allclose(np.asarray(diags[k]),
                                       want_diags[k], rtol=1e-12,
                                       atol=1e-22, err_msg=k)
    # and the poison provably never reaches an active cell's PAR
    assert np.all(np.isfinite(np.asarray(tend)))


def test_dms_diag_registry_complete(rng):
    tracers, dz, kmax, sst, sw = _setup(rng, nlev=4, ncol=5)
    params = DMSParams()
    active = np.arange(4)[:, None] < kmax[None, :]
    _, diags = dms_source_sink(
        jnp.asarray(tracers), jnp.asarray(dz), jnp.asarray(active),
        jnp.asarray(sst), jnp.asarray(sw), params)
    from ocean_bgc.ops.dms import DMS_DIAG_NAMES
    assert set(diags) == set(DMS_DIAG_NAMES)
    assert len(DMS_DIAG_NAMES) == 27   # DMS_parms.F90:125-154


def test_dms_uv_field_matches_sequential_recurrence(rng):
    """Opt-in UV diagnostics (DMS_mod.F90:509-510, 531-536): surface UV
    is 1% of surface PAR, attenuated downward by KUVdz = (0.01e-2*DOC +
    0.04e-4)*dz.  The kernel's closed-form cumprod must match the
    reference's sequential k-recurrence, written out independently here
    in float64 NumPy."""
    tracers, dz, kmax, sst, sw = _setup(rng)
    nlev, ncol = dz.shape
    active = np.arange(nlev)[:, None] < kmax[None, :]
    _, diags = dms_source_sink(
        jnp.asarray(tracers), jnp.asarray(dz), jnp.asarray(active),
        jnp.asarray(sst), jnp.asarray(sw), DMSParams(), compute_uv=True)
    for k in ("UV_in", "UV_out", "UV_avg"):
        assert k in diags

    from ocean_bgc.constants import F_QSW_PAR_DMS
    clip = np.maximum(tracers, 0.0)
    want_in = np.zeros((nlev, ncol))
    want_out = np.zeros((nlev, ncol))
    want_avg = np.zeros((nlev, ncol))
    for col in range(ncol):
        uv_out = max(0.0, sw[col]) * F_QSW_PAR_DMS * 0.01
        for k in range(kmax[col]):
            uv_in = uv_out
            kuv_dz = (0.01e-2 * clip[k, DT.DOC, col] + 0.04e-4) \
                * dz[k, col]
            uv_out = uv_in * np.exp(-kuv_dz)
            want_in[k, col] = uv_in
            want_out[k, col] = uv_out
            want_avg[k, col] = uv_in * (1.0 - np.exp(-kuv_dz)) / kuv_dz
    np.testing.assert_allclose(np.asarray(diags["UV_in"]), want_in,
                               rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(np.asarray(diags["UV_out"]), want_out,
                               rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(np.asarray(diags["UV_avg"]), want_avg,
                               rtol=1e-12, atol=0.0)
    # default call emits exactly the 27 reference diagnostics, UV off
    _, d0 = dms_source_sink(
        jnp.asarray(tracers), jnp.asarray(dz), jnp.asarray(active),
        jnp.asarray(sst), jnp.asarray(sw), DMSParams())
    assert "UV_in" not in d0
