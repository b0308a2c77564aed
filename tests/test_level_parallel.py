"""Edge-case pins for the closed-form level-parallel building blocks.

The BGC kernel replaces two of the reference's downward recurrences with
closed/vectorized forms (ops/bgc.py): PAR attenuation (BGC_mod.F90:
907-924) as an exclusive cumulative product, and the saturation-depth
search (BGC_mod.F90:1003-1032) as a first-crossing scan over the
pre-solved CO3 field.  The oracle suite exercises them on synthetic
worlds; here we pin them against literal sequential NumPy replicas of
the reference's per-level state machines on adversarial columns: land,
single-level, never-crossing, crossing-at-bottom, surface-undersaturated,
and ragged-depth freeze semantics.
"""

import numpy as np
import jax.numpy as jnp

from ocean_bgc.ops.bgc import _par_field, _zsat_search


def _par_scan_reference(par_surf, total_chl, dz, active):
    """Literal downward recurrence (BGC_mod.F90:907-924) with the frozen
    below-bottom carry of the level scan."""
    nlev, ncol = total_chl.shape
    par_in = np.zeros((nlev, ncol))
    par_out = np.zeros((nlev, ncol))
    par_avg = np.zeros((nlev, ncol))
    kpar_dz = np.zeros((nlev, ncol))
    carry = par_surf.copy()
    for k in range(nlev):
        chl = np.maximum(total_chl[k], 0.02)
        kpar = np.where(chl < 0.13224,
                        0.000919 * chl ** 0.3536,
                        0.001131 * chl ** 0.4562)
        kdz = kpar * dz[k]
        att = np.exp(-kdz)
        par_in[k] = carry
        par_out[k] = carry * att
        par_avg[k] = carry * (1.0 - att) / kdz
        kpar_dz[k] = kdz
        carry = np.where(active[k], par_out[k], carry)
    return par_in, par_out, par_avg, kpar_dz


def _zsat_scan_reference(anom, center, prev_center, bottom, active, kmax):
    """Literal replica of the scan-based _zsat_update state machine that
    ops/bgc.py previously threaded through the level loop."""
    nlev, ncol = anom.shape
    zsat = np.zeros(ncol)
    anom_km1 = np.zeros(ncol)
    for k in range(nlev):
        is_bottom = (k + 1) == kmax
        init = np.where(anom[k] > 0.0, -1.0, 0.0)
        crossed = (zsat == -1.0) & (anom[k] <= 0.0)
        den = anom_km1 - anom[k]
        interp_depth = prev_center[k] + (center[k] - prev_center[k])
        interp = interp_depth * anom_km1 / np.where(den != 0.0, den, 1.0)
        zs = np.where(crossed, interp, zsat)
        zs = np.where((zs == -1.0) & is_bottom, bottom[k], zs)
        zs = np.where(k == 0, init, zs)
        zsat = np.where(active[k], zs, zsat)
        anom_km1 = np.where(active[k], anom[k], anom_km1)
    return zsat


def _grid_arrays(nlev, kmax):
    ncol = len(kmax)
    dz = np.full((nlev, ncol), 1000.0)          # 10 m cells, in cm
    bottom = np.cumsum(dz, axis=0)
    center = bottom - 0.5 * dz
    prev_center = np.vstack([np.zeros((1, ncol)), center[:-1]])
    k = np.arange(nlev)[:, None]
    active = k < np.asarray(kmax)[None, :]
    return dz, bottom, center, prev_center, active


def test_par_field_matches_sequential_recurrence():
    rng = np.random.default_rng(11)
    nlev = 12
    kmax = np.array([0, 1, 3, 12, 7, 12])        # land / shallow / full
    dz, bottom, center, prev_center, active = _grid_arrays(nlev, kmax)
    ncol = len(kmax)
    par_surf = rng.uniform(0.0, 120.0, ncol)
    total_chl = rng.uniform(0.0, 2.0, (nlev, ncol))
    total_chl[:, 2] = 0.0                        # exercises the chl floor

    want = _par_scan_reference(par_surf, total_chl, dz, active)
    got = _par_field(jnp.asarray(par_surf), jnp.asarray(total_chl),
                     jnp.asarray(dz), jnp.asarray(active))
    for g, w, name in zip(got, want, ("par_in", "par_out", "par_avg",
                                      "kpar_dz")):
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-12,
                                   atol=1e-300, err_msg=name)


def test_zsat_search_edge_cases():
    nlev = 8
    # columns: 0 land; 1 single-level supersat (stays -1, faithfully);
    # 2 single-level undersat (0); 3 surface undersat (0);
    # 4 crossing mid-column; 5 crossing exactly at the bottom cell;
    # 6 never crossing (bottom depth); 7 ragged, crossing below a
    #   shallower column's floor must NOT register there
    kmax = np.array([0, 1, 1, 8, 8, 8, 8, 3])
    dz, bottom, center, prev_center, active = _grid_arrays(nlev, kmax)
    ncol = len(kmax)

    anom = np.ones((nlev, ncol))
    anom[:, 1] = 1.0
    anom[:, 2] = -0.5
    anom[0, 3] = -0.2
    anom[:, 4] = np.linspace(1.0, -1.0, nlev)    # crosses mid-column
    anom[:, 5] = 1.0
    anom[-1, 5] = -1.0                           # crosses at bottom cell
    anom[:, 6] = 2.0                             # never crosses
    anom[:, 7] = 1.0
    anom[5, 7] = -1.0                            # below kmax=3 floor

    want = _zsat_scan_reference(anom, center, prev_center, bottom,
                                active, kmax)
    got = np.asarray(_zsat_search(
        jnp.asarray(anom), jnp.asarray(center), jnp.asarray(prev_center),
        jnp.asarray(bottom), jnp.asarray(active), jnp.asarray(kmax)))
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0.0)

    assert got[0] == 0.0                         # land
    assert got[1] == -1.0                        # 1-level supersat quirk
    assert got[2] == 0.0
    assert got[3] == 0.0
    assert got[6] == bottom[kmax[6] - 1, 6]      # never-crossing -> floor
    assert got[7] == bottom[kmax[7] - 1, 7]      # deep crossing ignored


def test_zsat_search_randomized_against_state_machine():
    rng = np.random.default_rng(23)
    nlev = 10
    ncol = 64
    kmax = rng.integers(0, nlev + 1, ncol)
    dz, bottom, center, prev_center, active = _grid_arrays(nlev, kmax)
    anom = rng.normal(0.0, 1.0, (nlev, ncol))
    want = _zsat_scan_reference(anom, center, prev_center, bottom,
                                active, kmax)
    got = np.asarray(_zsat_search(
        jnp.asarray(anom), jnp.asarray(center), jnp.asarray(prev_center),
        jnp.asarray(bottom), jnp.asarray(active), jnp.asarray(kmax)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
