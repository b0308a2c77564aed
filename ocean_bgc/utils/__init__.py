from ocean_bgc.utils import synthetic  # noqa: F401
