from .distributed import (  # noqa: F401
    initialize_distributed,
    make_global_array,
    maybe_initialize_distributed,
    shard_params_global,
)
from .mesh import (  # noqa: F401
    Mesh,
    Placement,
    data_sharding,
    kv_cache_shardings,
    make_mesh,
    param_shardings,
    seq_constraint,
    shard_params,
    xa_kv_shardings,
)
from .replay import Held, Replay  # noqa: F401
