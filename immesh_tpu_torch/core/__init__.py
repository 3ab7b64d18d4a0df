from immesh_tpu_torch.core import so3  # noqa: F401
from immesh_tpu_torch.core.state import EsikfState, STATE_DIM  # noqa: F401
