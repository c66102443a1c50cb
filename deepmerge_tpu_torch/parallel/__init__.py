from deepmerge_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    gather_params,
    make_mesh,
    replicate,
    shard_batch,
    shard_params,
)
