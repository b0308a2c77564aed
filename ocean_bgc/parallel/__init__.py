from ocean_bgc.parallel import sharding  # noqa: F401
from ocean_bgc.parallel.sharding import (  # noqa: F401
    make_mesh,
    make_pjit_forced_run,
    make_pjit_step,
    make_sharded_forced_run,
    make_sharded_step,
    shard_world,
)
