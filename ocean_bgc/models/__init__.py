from ocean_bgc.models import (  # noqa: F401
    adjoint,
    chunked,
    coupled,
    forcing_series,
    integrators,
)
