from repro_torch.parallel.ctx import (ShardCtx, bind, constrain, mesh_of,
                                      resolve, sharding_for)
from repro_torch.parallel.rules import RULESETS, rules_for

__all__ = [
    "bind", "resolve", "sharding_for", "constrain",
    "ShardCtx", "mesh_of", "RULESETS", "rules_for",
]
