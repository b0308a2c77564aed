"""Tunable parameter sets (the reference's "namelist" layer) as frozen dataclasses.

The reference holds these as mutable Fortran module variables filled by
``*_parms_init`` (BGC_parms.F90:497-699, DMS_parms.F90:203-241,
MACROS_parms.F90:143-162) and documents them as namelist-overridable. Here
each family is an immutable, hashable dataclass of Python floats — static
under ``jax.jit``, so parameter values fold into the compiled kernel as
constants (retuning triggers a retrace, which is the right trade for a
production configuration that is fixed over a run).

Autotroph functional-group traits (``autotroph_type``, BGC_parms.F90:51-79)
become one frozen ``AutotrophTraits`` per group; the canonical 4-tuple with
reference defaults is built by :func:`default_autotrophs`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ocean_bgc.constants import DPS, TFNC_Q10, TFNC_QUASI_MMRT


@dataclasses.dataclass(frozen=True)
class AutotrophTraits:
    """Traits of one autotroph functional group (BGC_parms.F90:51-79).

    Structural flags (``nfixer``, ``imp_calcifier``, ``exp_calcifier``,
    ``has_si``, ``grazee_ind``, ``temp_function``) are Python bools/ints and
    steer *unrolled* per-group code paths at trace time — the compiled
    replacement for the reference's runtime if-chains over trait fields.
    """

    sname: str
    lname: str
    nfixer: bool
    imp_calcifier: bool
    exp_calcifier: bool
    grazee_ind: int          # shared-grazee-class id (BGC_parms.F90:58)
    temp_function: int       # TFNC_Q10 | TFNC_QUASI_MMRT
    has_si: bool             # reference encodes this as kSiO3 > 0 / Si_ind > 0
    kFe: float
    kPO4: float
    kDOP: float
    kNO3: float
    kNH4: float
    kSiO3: float
    Qp: float
    gQfe_0: float
    gQfe_min: float
    alphaPI: float
    PCref: float
    thetaN_max: float
    loss_thres: float
    loss_thres2: float
    temp_thres: float
    temp_thresN: float
    temp_thresS: float
    temp_optN: float
    temp_optS: float
    mort: float
    mort2: float
    agg_rate_max: float
    agg_rate_min: float
    z_umax_0: float
    z_grz: float
    graze_zoo: float
    graze_poc: float
    graze_doc: float
    loss_poc: float
    f_zoo_detr: float


def default_autotrophs() -> Tuple[AutotrophTraits, ...]:
    """The reference's four groups with default traits (BGC_parms.F90:543-697)."""
    sp = AutotrophTraits(
        sname="sp", lname="Small Phyto",
        nfixer=False, imp_calcifier=True, exp_calcifier=False,
        grazee_ind=0, temp_function=TFNC_Q10, has_si=False,
        kFe=0.04e-3, kPO4=0.01, kDOP=0.26, kNO3=0.1, kNH4=0.01, kSiO3=0.0,
        Qp=0.00855, gQfe_0=20.0e-6, gQfe_min=3.0e-6,
        alphaPI=0.6 * DPS, PCref=5.5 * DPS, thetaN_max=2.5,
        loss_thres=0.04, loss_thres2=0.0,
        temp_thres=-20.0, temp_thresN=-20.0, temp_thresS=-20.0,
        temp_optN=50.0, temp_optS=50.0,
        mort=0.12 * DPS, mort2=0.001 * DPS,
        agg_rate_max=0.9, agg_rate_min=0.01,
        z_umax_0=3.3 * DPS, z_grz=1.05,
        graze_zoo=0.3, graze_poc=0.0, graze_doc=0.15,
        loss_poc=0.0, f_zoo_detr=0.15,
    )
    diat = AutotrophTraits(
        sname="diat", lname="Diatom",
        nfixer=False, imp_calcifier=False, exp_calcifier=False,
        grazee_ind=1, temp_function=TFNC_Q10, has_si=True,
        kFe=0.06e-3, kPO4=0.05, kDOP=0.9, kNO3=0.5, kNH4=0.05, kSiO3=0.8,
        Qp=0.00855, gQfe_0=20.0e-6, gQfe_min=3.0e-6,
        alphaPI=0.465 * DPS, PCref=5.5 * DPS, thetaN_max=4.0,
        loss_thres=0.04, loss_thres2=0.0,
        temp_thres=-20.0, temp_thresN=35.0, temp_thresS=10.0,
        temp_optN=16.3, temp_optS=5.0,
        mort=0.12 * DPS, mort2=0.001 * DPS,
        agg_rate_max=0.9, agg_rate_min=0.02,
        z_umax_0=3.23 * DPS, z_grz=1.0,
        graze_zoo=0.3, graze_poc=0.42, graze_doc=0.15,
        loss_poc=0.0, f_zoo_detr=0.2,
    )
    diaz = AutotrophTraits(
        sname="diaz", lname="Diazotroph",
        nfixer=True, imp_calcifier=False, exp_calcifier=False,
        grazee_ind=2, temp_function=TFNC_Q10, has_si=False,
        kFe=0.04e-3, kPO4=0.02, kDOP=0.09, kNO3=1.0, kNH4=0.15, kSiO3=0.0,
        Qp=0.002735, gQfe_0=60.0e-6, gQfe_min=12.0e-6,
        alphaPI=0.4 * DPS, PCref=0.7 * DPS, thetaN_max=2.5,
        loss_thres=0.022, loss_thres2=0.001,
        temp_thres=14.0, temp_thresN=-20.0, temp_thresS=-20.0,
        temp_optN=50.0, temp_optS=50.0,
        mort=0.15 * DPS, mort2=0.0,
        agg_rate_max=0.0, agg_rate_min=0.0,
        z_umax_0=0.6 * DPS, z_grz=1.2,
        graze_zoo=0.3, graze_poc=0.05, graze_doc=0.15,
        loss_poc=0.0, f_zoo_detr=0.15,
    )
    phaeo = AutotrophTraits(
        sname="phaeo", lname="Phaeocystis",
        nfixer=False, imp_calcifier=False, exp_calcifier=False,
        grazee_ind=1,  # grazed with diatoms (BGC_parms.F90:666)
        temp_function=TFNC_QUASI_MMRT, has_si=False,
        kFe=0.075e-3, kPO4=0.05, kDOP=0.9, kNO3=0.7, kNH4=0.05, kSiO3=0.0,
        Qp=0.00855, gQfe_0=20.0e-6, gQfe_min=3.0e-6,
        alphaPI=0.77 * DPS, PCref=5.5 * DPS, thetaN_max=2.5,
        loss_thres=0.04, loss_thres2=0.0,
        temp_thres=-20.0, temp_thresN=35.0, temp_thresS=10.0,
        temp_optN=16.3, temp_optS=5.0,
        mort=0.12 * DPS, mort2=0.001 * DPS,
        agg_rate_max=0.9, agg_rate_min=0.02,
        z_umax_0=3.23 * DPS, z_grz=1.0,
        graze_zoo=0.3, graze_poc=0.42, graze_doc=0.15,
        loss_poc=0.0, f_zoo_detr=0.2,
    )
    return (sp, diat, diaz, phaeo)


@dataclasses.dataclass(frozen=True)
class BGCParams:
    """Namelist-tunable ecosystem parameters (BGC_parms.F90:346-365, 524-541)
    plus the runtime switches the reference keeps as module flags
    (BGC_mod.F90:131-134, 360; BGC_parms.F90:162-164)."""

    parm_Fe_bioavail: float = 1.0
    parm_o2_min: float = 4.0
    parm_o2_min_delta: float = 2.0
    parm_kappa_nitrif: float = 0.06 * DPS
    parm_nitrif_par_lim: float = 1.0
    parm_z_mort_0: float = 0.1 * DPS
    parm_z_mort2_0: float = 0.4 * DPS
    parm_labile_ratio: float = 0.85
    parm_POMbury: float = 1.4
    parm_BSIbury: float = 0.65
    parm_fe_scavenge_rate0: float = 3.0
    parm_f_prod_sp_CaCO3: float = 0.055
    parm_POC_diss: float = 88.0e2
    parm_SiO2_diss: float = 250.0e2
    parm_CaCO3_diss: float = 150.0e2
    # prescribed dissolution scale-length profile (BGC_parms.F90:540-541)
    parm_scalelen_z: Tuple[float, float, float, float] = (
        130.0e2, 290.0e2, 670.0e2, 1700.0e2)
    parm_scalelen_vals: Tuple[float, float, float, float] = (1.0, 3.0, 5.0, 9.0)
    # runtime switches
    lrest_po4: bool = False
    lrest_no3: bool = False
    lrest_sio3: bool = False
    alt_co2_use_eco: bool = True
    lcalc_O2_gas_flux: bool = True
    lcalc_CO2_gas_flux: bool = True
    # hard-coded .true. in the reference (BGC_mod.F90:2764)
    locmip_k1_k2_bug_fix: bool = True

    autotrophs: Tuple[AutotrophTraits, ...] = dataclasses.field(
        default_factory=default_autotrophs)


@dataclasses.dataclass(frozen=True)
class DMSParams:
    """Sulfur-cycle parameters with defaults of DMS_parms_init (DMS_parms.F90:209-237)."""

    k_S_p_base: float = 0.1 * DPS
    zooC_avg: float = 0.3
    mort: float = 0.0
    k_conv: float = 1.0 * DPS
    k_S_z: float = 0.1 * DPS
    B_preexp: float = 0.1
    B_exp: float = 0.5
    k_S_B: float = 30.0 * DPS
    k_bkgnd: float = 0.01 * DPS
    j_dms_perI: float = 0.005 * DPS
    inject_scale: float = 1.00
    T_cryo_hi: float = 1.0
    T_cryo_lo: float = -1.0
    T_lo: float = 15.0
    T_hi: float = 20.0
    Min_cyano_frac: float = 0.0
    Max_cyano_frac: float = 0.5
    Min_yld: float = 0.2
    Max_yld: float = 0.7
    G_phaeo_S: float = 0.4
    Sp_ref: float = 0.1
    Stress_mult: float = 10.0
    R: float = 0.137
    Rs2n_diat: float = 0.01
    Rs2n_phaeo: float = 0.3
    Rs2n_cocco: float = 0.1
    Rs2n_cyano: float = 0.0
    Rs2n_eukar: float = 0.1
    Rs2n_diaz: float = 0.0
    lcalc_DMS_gas_flux: bool = True


@dataclasses.dataclass(frozen=True)
class MACROSParams:
    """Macromolecule parameters with defaults of MACROS_parms_init
    (MACROS_parms.F90:149-158)."""

    f_prot: float = 0.6
    f_poly: float = 0.2
    f_lip: float = 0.2
    k_C_p_base: float = 0.1 * DPS
    zooC_avg: float = 0.3
    mort: float = 0.0
    k_prot_bac: float = 0.1 * DPS
    k_poly_bac: float = 0.01 * DPS
    k_lip_bac: float = 1.0 * DPS
    inject_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class ModelParams:
    """The full coupled-model parameter bundle."""

    bgc: BGCParams = dataclasses.field(default_factory=BGCParams)
    dms: DMSParams = dataclasses.field(default_factory=DMSParams)
    macros: MACROSParams = dataclasses.field(default_factory=MACROSParams)
