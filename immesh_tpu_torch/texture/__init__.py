from immesh_tpu_torch.texture.camera import PinholeCamera, project_points, bilinear_sample  # noqa: F401
from immesh_tpu_torch.texture.render import ColorStore, render_points  # noqa: F401
from immesh_tpu_torch.texture.optical_flow import build_pyramid, lk_track  # noqa: F401
