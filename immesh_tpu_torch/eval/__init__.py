from immesh_tpu_torch.eval.ate import (  # noqa: F401
    Trajectory, align_umeyama, associate_stamps, ate_rmse, evaluate_ate,
    from_rows, load_tum, rpe,
)
