from .context import activation_mesh, constrain, current_mesh  # noqa: F401
from .rules import (batch_sharding, cache_sharding,  # noqa: F401
                    opt_state_sharding, param_sharding, placements)
