from immesh_tpu_torch.frontend.types import ScanBundle  # noqa: F401
