"""Ranks of a ``(data, model)`` mesh: counterpart of the JAX package's
``parallel``. ``mesh.py`` holds the mesh, its collectives and the sharding
rule; ``sharded_step.py`` the steps over a whole batch; ``launch.py`` starts
the ranks of one machine."""

from pytorch_scalablefhvae_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    padded_num_seqs,
    shard_batch,
    shard_model,
)

__all__ = ["Mesh", "make_mesh", "padded_num_seqs", "shard_batch",
           "shard_model"]
