"""The multi-device layer (counterpart of `rfhe_tpu/parallel`): meshes over
torch.distributed, the launcher of process worlds, the limb-sharded
ciphertext (`mesh.py`) and the CKKS evaluator on it (`sharded_ckks.py`).
The sharded NTTs are in `transform/distributed.py` and
`transform/mxu_sharded.py`."""
from .mesh import (  # noqa: F401
    ShardedCiphertext, gather_ciphertext, init_multihost, make_mesh, make_mesh_2d,
    shard_ciphertext, spawn_world,
)
