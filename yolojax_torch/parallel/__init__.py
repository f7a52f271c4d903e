"""Multi-device runs: the mesh over processes and its sharding rules
(``mesh``), the process group (``distributed``), the collectives with their
gradients (``collectives``), a train state laid out over a mesh
(``sharding``) and spawned ranks for tests and checks (``launch``). Port of
``yolojax/parallel``."""

from yolojax_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    opt_state_shard_dims,
    param_shard_dims,
    shard_batch,
)
