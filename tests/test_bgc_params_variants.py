"""BGC kernel vs oracle under non-default parameter configurations."""

import dataclasses

import numpy as np

import ocean_bgc  # noqa: F401
import jax.numpy as jnp

from ocean_bgc.ops.bgc import bgc_source_sink
from ocean_bgc.params import BGCParams
from tests.oracle import bgc_ref
from tests.test_bgc import _forcing_dict, _grid_dict, make_inputs


def _compare(rng, params):
    trc, grid, forcing, _, ph_prev, ph_alt = make_inputs(rng)
    out = bgc_source_sink(jnp.asarray(trc), grid, forcing,
                          jnp.asarray(ph_prev), jnp.asarray(ph_alt), params)
    want_tend, *_ = bgc_ref.bgc_source_sink_ref(
        trc, _grid_dict(grid), _forcing_dict(forcing), ph_prev, ph_alt,
        params)
    np.testing.assert_allclose(np.asarray(out.tendencies), want_tend,
                               rtol=1e-9, atol=1e-22)
    return out


def test_abiotic_alt_co2(rng):
    out = _compare(rng, BGCParams(alt_co2_use_eco=False))
    # DIC_ALT tendency must be exactly zero everywhere
    assert (np.asarray(out.tendencies)[:, 7] == 0.0).all()


def test_retuned_rates(rng):
    params = BGCParams(
        parm_Fe_bioavail=0.6,
        parm_o2_min=6.0, parm_o2_min_delta=3.0,
        parm_kappa_nitrif=0.1 / 86400.0,
        parm_z_mort2_0=0.3 / 86400.0,
        parm_labile_ratio=0.7,
        parm_POMbury=1.0, parm_BSIbury=1.0,
        parm_fe_scavenge_rate0=5.0,
        parm_f_prod_sp_CaCO3=0.08,
        parm_POC_diss=60.0e2, parm_SiO2_diss=300.0e2,
        parm_CaCO3_diss=100.0e2,
        parm_scalelen_vals=(1.0, 2.0, 4.0, 8.0),
    )
    _compare(rng, params)


def test_retuned_autotroph_traits(rng):
    base = BGCParams()
    groups = list(base.autotrophs)
    groups[0] = dataclasses.replace(groups[0], PCref=7.0 / 86400.0,
                                    graze_zoo=0.25)
    groups[1] = dataclasses.replace(groups[1], kSiO3=1.2, gQfe_0=25e-6)
    groups[2] = dataclasses.replace(groups[2], temp_thres=12.0)
    groups[3] = dataclasses.replace(groups[3], temp_optN=18.0,
                                    temp_thresS=12.0)
    _compare(rng, dataclasses.replace(base, autotrophs=tuple(groups)))
