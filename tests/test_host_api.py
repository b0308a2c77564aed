"""The drop-in host-coupling API (reference entry-point surface)."""

import numpy as np

import ocean_bgc  # noqa: F401
from ocean_bgc import host_api
from ocean_bgc.state import BGCTracers as BT


def _host_world(rng, ncol=6, nlev=8):
    dz = rng.uniform(500.0, 4000.0, (ncol, nlev))
    zbot = np.cumsum(dz, axis=1)
    zcen = zbot - 0.5 * dz
    trc = rng.uniform(0.0, 3.0, (ncol, nlev, 30))
    trc[..., BT.DIC] = rng.uniform(1800, 2400, (ncol, nlev))
    trc[..., BT.ALK] = rng.uniform(2000, 2500, (ncol, nlev))
    trc[..., BT.O2] = rng.uniform(0, 350, (ncol, nlev))
    kmax = rng.integers(1, nlev + 1, ncol).astype(np.int32)
    return dict(dz=dz, zbot=zbot, zcen=zcen, trc=trc, kmax=kmax)


def test_metadata_entry_points():
    meta = host_api.bgc_init()
    assert len(meta.short_name) == host_api.BGC_tracer_cnt == 30
    assert meta.units[8] == "meq/m^3"          # ALK
    assert host_api.DMS_tracer_cnt == 14
    assert host_api.MACROS_tracer_cnt == 8
    params = host_api.bgc_parms_init(parm_Fe_bioavail=0.5)
    assert params.parm_Fe_bioavail == 0.5

    # field-for-field metadata diff vs the reference init routines:
    # every (short, long, units) triple DMS_init/MACROS_init registers
    # (DMS_mod.F90:101-144, MACROS_mod.F90:100-126), verbatim — the
    # reference's leading spaces included
    dms = host_api.dms_init()
    dms_map = dict(zip(dms.short_name, dms.long_name))
    assert dms_map == {
        "DMS": "DiMethyl Sulfide",
        "DMSP": "Dimethylsulfoniopropionate",
        "NO3": "Dissolved Inorganic Nitrate",
        "DOC": "Dissolved Organic Carbon",
        "zooC": "Zooplankton Carbon",
        "spChl": " Small Phytoplankton Chlorophyll",
        "diatChl": " Diatom Chlorophyll",
        "diazChl": " Diazotroph Chlorophyll",
        "phaeoChl": "Phaeocystis Chlorophyll",
        "spC": " Small Phytoplankton Carbon",
        "diatC": " Diatom Carbon",
        "diazC": " Diazotroph Carbon",
        "phaeoC": "Phaeocystis Carbon",
        "spCaCO3": " Small Phytoplankton Calcium Carbonate",
    }
    assert set(dms.units) == {"mmol/m^3"}       # DMS_mod.F90:144
    mac = host_api.macros_init()
    mac_map = dict(zip(mac.short_name, mac.long_name))
    assert mac_map == {
        "PROT": "Proteins",
        "POLY": "Polysaccharides",
        "LIP": "Lipids",
        "zooC": "Zooplankton Carbon",
        "spC": " Small Phytoplankton Carbon",
        "diatC": " Diatom Carbon",
        "diazC": " Diazotroph Carbon",
        "phaeoC": "Phaeocystis Carbon",
    }
    assert set(mac.units) == {"mmol/m^3"}       # MACROS_mod.F90:126


def test_bgc_source_sink_host_layout(rng):
    w = _host_world(rng)
    ncol, nlev = w["dz"].shape
    out = host_api.BGC_SourceSink(
        BGC_tracers=w["trc"],
        PotentialTemperature=rng.uniform(-1, 30, (ncol, nlev)),
        Salinity=rng.uniform(32, 36, (ncol, nlev)),
        cell_center_depth=w["zcen"], cell_thickness=w["dz"],
        cell_bottom_depth=w["zbot"],
        cell_latitude=rng.uniform(-70, 70, ncol),
        number_of_active_levels=w["kmax"],
        dust_FLUX_IN=rng.uniform(0, 1e-9, ncol),
        ShortWaveFlux_surface=rng.uniform(0, 300, ncol),
    )
    tend = out["BGC_tendencies"]
    assert tend.shape == (ncol, nlev, 30)
    assert np.isfinite(tend).all()
    # host layout honored: padded levels are zero per column
    for c in range(ncol):
        assert (tend[c, w["kmax"][c]:, :] == 0.0).all()
    assert out["PH_PREV_3D"].shape == (ncol, nlev)
    assert np.isfinite(out["PH_PREV_3D"]).all()


def test_surface_and_trace_gas_entry_points(rng):
    w = _host_world(rng)
    ncol, nlev = w["dz"].shape
    sst = rng.uniform(-1, 29, ncol)
    sss = rng.uniform(32, 37, ncol)
    out = host_api.BGC_SurfaceFluxes(
        BGC_tracers=w["trc"], SST=sst, SSS=sss,
        surfacePressure=np.ones(ncol), iceFraction=np.zeros(ncol),
        windSpeedSquared10m=rng.uniform(0, 2e6, ncol),
        atmCO2=np.full(ncol, 415.0), atmCO2_ALT_CO2=np.full(ncol, 284.0),
        surfaceDepth=np.zeros(ncol),
    )
    assert out["netFlux"].shape == (ncol, 30)
    assert (np.abs(out["netFlux"][:, BT.O2]) > 0).any()
    assert (out["surface_pH"] > 6).all() and (out["surface_pH"] < 10).all()

    dms_trc = rng.uniform(0, 1, (ncol, nlev, 14))
    out2 = host_api.DMS_SourceSink(
        DMS_tracers=dms_trc, cell_thickness=w["dz"],
        number_of_active_levels=w["kmax"], SST=sst,
        ShortWaveFlux_surface=rng.uniform(0, 300, ncol))
    assert out2["DMS_tendencies"].shape == (ncol, nlev, 14)

    out3 = host_api.DMS_SurfaceFluxes(
        DMS_tracers=dms_trc, SST=sst, SSS=sss,
        iceFraction=np.zeros(ncol),
        windSpeedSquared10m=rng.uniform(0, 2e6, ncol),
        surfacePressure=np.ones(ncol))
    assert (out3["netFlux_dms"] <= 0).all()   # outgassing only (sat = 0)
    assert (out3["netFlux_dmsp"] == 0).all()

    out4 = host_api.MACROS_SourceSink(
        MACROS_tracers=rng.uniform(0, 2, (ncol, nlev, 8)),
        number_of_active_levels=w["kmax"])
    assert out4["MACROS_tendencies"].shape == (ncol, nlev, 8)
    assert np.isfinite(out4["MACROS_tendencies"]).all()


def test_host_tracer_order_adapter_bitwise(rng):
    """A host using its OWN tracer order (the reference's indices-struct
    contract, BGC_parms.F90:81-125) gets bitwise-identical physics via
    the boundary permutation adapter."""
    from ocean_bgc.state import (BGC_TRACER_NAMES, DMS_TRACER_NAMES,
                                 MACROS_TRACER_NAMES)

    w = _host_world(rng)
    ncol, nlev = w["dz"].shape
    common = dict(
        PotentialTemperature=rng.uniform(-1, 30, (ncol, nlev)),
        Salinity=rng.uniform(32, 36, (ncol, nlev)),
        cell_center_depth=w["zcen"], cell_thickness=w["dz"],
        cell_bottom_depth=w["zbot"],
        cell_latitude=rng.uniform(-70, 70, ncol),
        number_of_active_levels=w["kmax"],
        dust_FLUX_IN=rng.uniform(0, 1e-9, ncol),
        ShortWaveFlux_surface=rng.uniform(0, 300, ncol),
    )
    ref = host_api.BGC_SourceSink(BGC_tracers=w["trc"], **common)

    # scramble: host keeps tracer c at position perm[c]
    perm = rng.permutation(30)
    indices = {n: int(perm[c]) for c, n in enumerate(BGC_TRACER_NAMES)}
    host_trc = np.empty_like(w["trc"])
    host_trc[..., perm] = w["trc"]
    got = host_api.BGC_SourceSink(BGC_tracers=host_trc, indices=indices,
                                  **common)
    want = np.empty_like(ref["BGC_tendencies"])
    want[..., perm] = ref["BGC_tendencies"]
    np.testing.assert_array_equal(got["BGC_tendencies"], want)
    np.testing.assert_array_equal(got["PH_PREV_3D"], ref["PH_PREV_3D"])

    # surface fluxes: per-tracer inputs AND netFlux follow the host order
    sf_common = dict(
        SST=rng.uniform(-1, 29, ncol), SSS=rng.uniform(32, 37, ncol),
        surfacePressure=np.ones(ncol), iceFraction=np.zeros(ncol),
        windSpeedSquared10m=rng.uniform(0, 2e6, ncol),
        atmCO2=np.full(ncol, 415.0), atmCO2_ALT_CO2=np.full(ncol, 284.0),
        surfaceDepth=np.zeros(ncol),
    )
    dep = rng.uniform(0, 1e-6, (ncol, 30))
    ref_sf = host_api.BGC_SurfaceFluxes(BGC_tracers=w["trc"],
                                        depositionFlux=dep, **sf_common)
    host_dep = np.empty_like(dep)
    host_dep[..., perm] = dep
    got_sf = host_api.BGC_SurfaceFluxes(BGC_tracers=host_trc,
                                        depositionFlux=host_dep,
                                        indices=indices, **sf_common)
    want_net = np.empty_like(ref_sf["netFlux"])
    want_net[..., perm] = ref_sf["netFlux"]
    np.testing.assert_array_equal(got_sf["netFlux"], want_net)
    np.testing.assert_array_equal(got_sf["surface_pH"],
                                  ref_sf["surface_pH"])

    # DMS + MACROS kernels through their own scrambles
    dms_trc = rng.uniform(0, 1, (ncol, nlev, 14))
    dperm = rng.permutation(14)
    dmap = {n: int(dperm[c]) for c, n in enumerate(DMS_TRACER_NAMES)}
    host_dms = np.empty_like(dms_trc)
    host_dms[..., dperm] = dms_trc
    ref_d = host_api.DMS_SourceSink(
        DMS_tracers=dms_trc, cell_thickness=w["dz"],
        number_of_active_levels=w["kmax"], SST=sf_common["SST"],
        ShortWaveFlux_surface=common["ShortWaveFlux_surface"])
    got_d = host_api.DMS_SourceSink(
        DMS_tracers=host_dms, cell_thickness=w["dz"],
        number_of_active_levels=w["kmax"], SST=sf_common["SST"],
        ShortWaveFlux_surface=common["ShortWaveFlux_surface"],
        indices=dmap)
    want_d = np.empty_like(ref_d["DMS_tendencies"])
    want_d[..., dperm] = ref_d["DMS_tendencies"]
    np.testing.assert_array_equal(got_d["DMS_tendencies"], want_d)

    ref_df = host_api.DMS_SurfaceFluxes(
        DMS_tracers=dms_trc, SST=sf_common["SST"], SSS=sf_common["SSS"],
        iceFraction=np.zeros(ncol),
        windSpeedSquared10m=sf_common["windSpeedSquared10m"],
        surfacePressure=np.ones(ncol))
    got_df = host_api.DMS_SurfaceFluxes(
        DMS_tracers=host_dms, SST=sf_common["SST"], SSS=sf_common["SSS"],
        iceFraction=np.zeros(ncol),
        windSpeedSquared10m=sf_common["windSpeedSquared10m"],
        surfacePressure=np.ones(ncol), indices=dmap)
    np.testing.assert_array_equal(got_df["netFlux_dms"],
                                  ref_df["netFlux_dms"])

    mac_trc = rng.uniform(0, 2, (ncol, nlev, 8))
    mperm = rng.permutation(8)
    mmap = {n: int(mperm[c]) for c, n in enumerate(MACROS_TRACER_NAMES)}
    host_mac = np.empty_like(mac_trc)
    host_mac[..., mperm] = mac_trc
    ref_m = host_api.MACROS_SourceSink(
        MACROS_tracers=mac_trc, number_of_active_levels=w["kmax"])
    got_m = host_api.MACROS_SourceSink(
        MACROS_tracers=host_mac, number_of_active_levels=w["kmax"],
        indices=mmap)
    want_m = np.empty_like(ref_m["MACROS_tendencies"])
    want_m[..., mperm] = ref_m["MACROS_tendencies"]
    np.testing.assert_array_equal(got_m["MACROS_tendencies"], want_m)


def test_host_tracer_index_map_validated():
    import pytest

    from ocean_bgc.state import BGC_TRACER_NAMES

    good = {n: i for i, n in enumerate(BGC_TRACER_NAMES)}
    assert (host_api.tracer_permutation(good, BGC_TRACER_NAMES)
            == np.arange(30)).all()
    # missing one name
    bad = dict(good)
    bad.pop("PO4")
    with pytest.raises(ValueError, match="missing"):
        host_api.tracer_permutation(bad, BGC_TRACER_NAMES)
    # unknown name
    bad = dict(good)
    bad["not_a_tracer"] = 3
    with pytest.raises(ValueError, match="unknown"):
        host_api.tracer_permutation(bad, BGC_TRACER_NAMES)
    # duplicate position (1-based maps also land here)
    bad = dict(good)
    bad["PO4"] = bad["NO3"]
    with pytest.raises(ValueError, match="permutation"):
        host_api.tracer_permutation(bad, BGC_TRACER_NAMES)


def test_bgc_source_sink_diag_names(rng):
    """diag_names emits exactly the requested diagnostics, values equal
    to the full run's to refusion ulps (pruning outputs changes XLA's
    fusion choices, so exact bitwise equality is not guaranteed)."""
    w = _host_world(rng)
    ncol, nlev = w["dz"].shape
    common = dict(
        BGC_tracers=w["trc"],
        PotentialTemperature=rng.uniform(-1, 30, (ncol, nlev)),
        Salinity=rng.uniform(32, 36, (ncol, nlev)),
        cell_center_depth=w["zcen"], cell_thickness=w["dz"],
        cell_bottom_depth=w["zbot"],
        cell_latitude=rng.uniform(-70, 70, ncol),
        number_of_active_levels=w["kmax"],
        dust_FLUX_IN=rng.uniform(0, 1e-9, ncol),
        ShortWaveFlux_surface=rng.uniform(0, 300, ncol),
    )
    full = host_api.BGC_SourceSink(**common)
    got = host_api.BGC_SourceSink(diag_names=("NITRIF", "POC_FLUX_IN"),
                                  **common)
    assert set(got["diags"]) == {"NITRIF", "POC_FLUX_IN"}
    for k in got["diags"]:
        np.testing.assert_allclose(got["diags"][k], full["diags"][k],
                                   rtol=1e-12, atol=1e-20)
    np.testing.assert_allclose(got["BGC_tendencies"],
                               full["BGC_tendencies"],
                               rtol=1e-12, atol=1e-20)
