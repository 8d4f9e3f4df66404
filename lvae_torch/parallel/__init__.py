"""Subject- and latent-parallel training and serving over torch.distributed."""

from lvae_torch.parallel.distributed import (  # noqa: F401
    initialize_distributed,
    make_global_mesh,
)
from lvae_torch.parallel.mesh import (  # noqa: F401
    ShardedHensmanTrainer,
    ShardedStandardTrainer,
    ShardedVITrainer,
    make_mesh,
    shard_hensman_state,
    shard_train_data,
    sharded_gp_predict,
)
