from ocean_bgc.ops import carbonate, schmidt  # noqa: F401
