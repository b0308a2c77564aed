"""IO layer: native host-layout marshaling, dependency-free NetCDF-3,
and the world/restart/history file bridge."""

from ocean_bgc.io import host_layout, netcdf3  # noqa: F401
from ocean_bgc.io.model_io import (  # noqa: F401
    load_world,
    save_history_netcdf,
    save_world,
)
