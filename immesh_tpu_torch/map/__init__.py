from immesh_tpu_torch.map.hash import HashTable  # noqa: F401
from immesh_tpu_torch.map.voxel_map import VoxelMap  # noqa: F401
