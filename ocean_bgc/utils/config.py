"""Runtime configuration: TOML / dict -> parameter pytrees.

The reference documents its parameters as namelist-overridable
(BGC_parms.F90:342-344, DMS_parms.F90:11-12) with the namelist read living
in the host.  This module is that host-side layer: a TOML file (or plain
dict) with ``[bgc]`` / ``[dms]`` / ``[macros]`` / ``[autotroph.<name>]``
tables overriding the frozen defaults.

Example::

    [bgc]
    parm_Fe_bioavail = 0.9
    lrest_no3 = true

    [autotroph.sp]
    PCref_per_day = 6.0      # *_per_day fields are converted with dps

    [dms]
    k_S_B_per_day = 25.0
"""

from __future__ import annotations

import dataclasses
import tomllib
from typing import Any, Dict, Mapping

from ocean_bgc.constants import DPS
from ocean_bgc.params import (
    BGCParams,
    DMSParams,
    MACROSParams,
    ModelParams,
)


def _apply(obj, overrides: Mapping[str, Any]):
    updates = {}
    valid = {f.name for f in dataclasses.fields(obj)}
    for key, val in overrides.items():
        if key.endswith("_per_day"):
            key, val = key[: -len("_per_day")], val * DPS
        if key not in valid:
            raise KeyError(
                f"unknown parameter {key!r} for {type(obj).__name__}")
        if isinstance(val, list):
            val = tuple(val)
        updates[key] = val
    return dataclasses.replace(obj, **updates)


def params_from_dict(cfg: Mapping[str, Any]) -> ModelParams:
    bgc = _apply(BGCParams(), cfg.get("bgc", {}))
    if "autotroph" in cfg:
        groups = list(bgc.autotrophs)
        by_name = {g.sname: i for i, g in enumerate(groups)}
        for name, over in cfg["autotroph"].items():
            if name not in by_name:
                raise KeyError(f"unknown autotroph {name!r}; "
                               f"have {sorted(by_name)}")
            i = by_name[name]
            groups[i] = _apply(groups[i], over)
        bgc = dataclasses.replace(bgc, autotrophs=tuple(groups))
    dms = _apply(DMSParams(), cfg.get("dms", {}))
    macros = _apply(MACROSParams(), cfg.get("macros", {}))
    return ModelParams(bgc=bgc, dms=dms, macros=macros)


def params_from_toml(path: str) -> ModelParams:
    with open(path, "rb") as f:
        cfg = tomllib.load(f)
    return params_from_dict(cfg)


def params_to_dict(params: ModelParams) -> Dict[str, Any]:
    """Round-trippable dump (autotrophs under [autotroph.<sname>])."""
    bgc = dataclasses.asdict(params.bgc)
    autos = bgc.pop("autotrophs")
    return {
        "bgc": bgc,
        "autotroph": {a["sname"]: a for a in autos},
        "dms": dataclasses.asdict(params.dms),
        "macros": dataclasses.asdict(params.macros),
    }
