"""Distribution layer: a mesh's named axes and their process groups
(:mod:`repro_torch.distributed.mesh_axes`), and the placements of params,
batches and caches on it (:mod:`repro_torch.distributed.sharding_rules`)."""

from repro_torch.distributed.sharding_rules import (  # noqa: F401
    batch_placements, cache_placements, param_placements, shard_params)
