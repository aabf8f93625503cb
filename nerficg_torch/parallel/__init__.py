"""Data-parallel training over ``torch.distributed``: the port of
nerficg_tpu/parallel (mesh.py, data_parallel.py)."""

from nerficg_torch.parallel.mesh import (DATA_AXIS, RenderMesh, make_mesh,
                                         replicated_spec, shard_rays_spec)
