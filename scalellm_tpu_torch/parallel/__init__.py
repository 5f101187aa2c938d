from scalellm_tpu_torch.parallel.config import ParallelConfig
from scalellm_tpu_torch.parallel.mesh import Mesh, make_mesh, single_mesh

__all__ = ["Mesh", "ParallelConfig", "make_mesh", "single_mesh"]
