"""ocean_bgc — an accelerator-native ocean biogeochemistry column framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
E3SM-Project/Ocean-BGC (the POP/MPAS column-physics library): the 30-tracer
multispecies ecosystem (BGC), the OCMIP2-style carbonate-chemistry solver
(co2calc), the 14-tracer DMS sulfur cycle, the 8-tracer macromolecule cycle
(MACROS), and air-sea gas exchange — all expressed as pure functions over
pytrees, vectorized over a batched `columns` axis, with the vertical
level loop as a fused `lax.scan`, and sharded over device meshes with
`shard_map` for multi-device scaling.

The numerical contract is float64 (the reference uses
`selected_real_kind(13)`, BGC_parms.F90:24), so importing this package
enables x64 mode globally.
"""

import jax as _jax

_jax.config.update("jax_enable_x64", True)

from ocean_bgc import constants, params, state  # noqa: E402,F401
from ocean_bgc.params import (  # noqa: E402,F401
    BGCParams,
    DMSParams,
    MACROSParams,
    ModelParams,
)
from ocean_bgc.state import (  # noqa: E402,F401
    BGCForcing,
    BGCState,
    BGCTracers,
    ColumnGrid,
    DMSTracers,
    MACROSTracers,
)

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level conveniences (avoid import cycles at package init)."""
    if name in ("step", "run", "CoupledState"):
        from ocean_bgc.models import coupled
        return getattr(coupled, name)
    if name in ("precompute_env", "EnvCache"):
        from ocean_bgc.ops import bgc
        return getattr(bgc, name)
    if name == "synthetic_world":
        from ocean_bgc.utils.synthetic import synthetic_world
        return synthetic_world
    raise AttributeError(name)
