"""Trajectory evaluation: ATE / RPE on TUM-format pose traces — a copy of
immesh_tpu/eval/ate.py (NumPy only).

The reference delegates accuracy evaluation to external tooling: it emits a
TUM-format pose trace per frame (`kitti_log`, reference
src/voxel_mapping_common.cpp:43-70) and the paper's ATE tables were produced
by running evo-style evaluators on those logs (SURVEY.md §4.2).  This module
makes the rebuild self-contained: it consumes exactly the trace our
`utils.timers.TrajectoryLogger` (and the reference binary) writes and
computes the standard metrics —

  * ATE RMSE after SE(3)/Sim(3) Umeyama alignment (Horn's method via SVD),
  * RPE (relative pose error) over a fixed frame delta,

entirely in NumPy on the host (a few thousand 3-vectors).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np


class Trajectory(NamedTuple):
    """Timestamped poses: stamps (N,), pos (N,3), quat_xyzw (N,4)."""
    stamps: np.ndarray
    pos: np.ndarray
    quat: np.ndarray

    @property
    def n(self) -> int:
        return int(self.stamps.shape[0])


def load_tum(path: str) -> Trajectory:
    """Read a TUM `t x y z qx qy qz qw` trace (the kitti_log schema)."""
    rows = np.loadtxt(path, dtype=np.float64, ndmin=2)
    if rows.size == 0:
        return Trajectory(np.zeros(0), np.zeros((0, 3)), np.zeros((0, 4)))
    if rows.shape[1] != 8:
        raise ValueError(f"{path}: expected 8 columns (TUM), got {rows.shape[1]}")
    return Trajectory(rows[:, 0], rows[:, 1:4], rows[:, 4:8])


def from_rows(rows: Sequence[Tuple[float, ...]]) -> Trajectory:
    """Build a Trajectory from TrajectoryLogger.rows tuples."""
    a = np.asarray(rows, np.float64).reshape(-1, 8)
    return Trajectory(a[:, 0], a[:, 1:4], a[:, 4:8])


def associate_stamps(t_a: np.ndarray, t_b: np.ndarray,
                     max_dt: float = 0.02) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy nearest-stamp association (the evo/TUM-toolkit convention).

    Returns index arrays (ia, ib) of matched pairs with |t_a-t_b| <= max_dt,
    each index used at most once, matched in order of ascending gap."""
    if t_a.size == 0 or t_b.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    # searchsorted needs t_b ascending; traces aren't guaranteed sorted
    # (merged logs, clock resets) — sort and translate indices back
    if np.any(np.diff(t_b) < 0):
        perm = np.argsort(t_b, kind="stable")
        ia, ib = associate_stamps(t_a, t_b[perm], max_dt)
        return ia, perm[ib]
    j = np.searchsorted(t_b, t_a)
    cand = []
    for i, jj in enumerate(j):
        for k in (jj - 1, jj):
            if 0 <= k < t_b.size:
                dt = abs(t_a[i] - t_b[k])
                if dt <= max_dt:
                    cand.append((dt, i, k))
    cand.sort()
    used_a: set = set()
    used_b: set = set()
    ia, ib = [], []
    for _, i, k in cand:
        if i in used_a or k in used_b:
            continue
        used_a.add(i)
        used_b.add(k)
        ia.append(i)
        ib.append(k)
    order = np.argsort(np.asarray(ia, np.int64))
    return np.asarray(ia, np.int64)[order], np.asarray(ib, np.int64)[order]


def align_umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = False
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares rigid (or similarity) transform src→dst.

    Returns (R, t, s) minimizing ||dst - (s R src + t)||².  Umeyama 1991 /
    Horn's closed form via SVD of the cross-covariance."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-18))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(est: np.ndarray, gt: np.ndarray, with_scale: bool = False
             ) -> Tuple[float, np.ndarray]:
    """Absolute trajectory error RMSE after Umeyama alignment.

    est/gt: (N,3) matched positions.  Returns (rmse, per-pose errors)."""
    R, t, s = align_umeyama(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    err = np.linalg.norm(aligned - gt, axis=1)
    return float(np.sqrt(np.mean(err ** 2))), err


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    """(N,4) xyzw → (N,3,3)."""
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    R = np.empty((q.shape[0], 3, 3))
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - z * w)
    R[:, 0, 2] = 2 * (x * z + y * w)
    R[:, 1, 0] = 2 * (x * y + z * w)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - x * w)
    R[:, 2, 0] = 2 * (x * z - y * w)
    R[:, 2, 1] = 2 * (y * z + x * w)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def rpe(est: Trajectory, gt: Trajectory, delta: int = 1,
        max_dt: float = 0.02) -> Tuple[float, float]:
    """Relative pose error over a frame delta: (trans RMSE m, rot RMSE rad)."""
    ia, ib = associate_stamps(est.stamps, gt.stamps, max_dt)
    if ia.size <= delta:
        return float("nan"), float("nan")
    Re = _quat_to_rot(est.quat[ia])
    Rg = _quat_to_rot(gt.quat[ib])
    pe, pg = est.pos[ia], gt.pos[ib]
    dt_err, dr_err = [], []
    for i in range(ia.size - delta):
        j = i + delta
        # relative motions in the respective body frames
        dRe = Re[i].T @ Re[j]
        dte = Re[i].T @ (pe[j] - pe[i])
        dRg = Rg[i].T @ Rg[j]
        dtg = Rg[i].T @ (pg[j] - pg[i])
        E = dRg.T @ dRe
        dt_err.append(np.linalg.norm(dte - dtg))
        c = np.clip((np.trace(E) - 1.0) / 2.0, -1.0, 1.0)
        dr_err.append(np.arccos(c))
    return (float(np.sqrt(np.mean(np.square(dt_err)))),
            float(np.sqrt(np.mean(np.square(dr_err)))))


def evaluate_ate(est: Trajectory, gt: Trajectory, max_dt: float = 0.02,
                 with_scale: bool = False) -> dict:
    """Full evaluation: associate → align → ATE (+RPE@1).  Returns a dict
    {ate_rmse, ate_mean, ate_median, ate_max, n_pairs, rpe_trans, rpe_rot}."""
    ia, ib = associate_stamps(est.stamps, gt.stamps, max_dt)
    if ia.size < 3:
        raise ValueError(f"only {ia.size} associated pairs (need >=3)")
    rmse, err = ate_rmse(est.pos[ia], gt.pos[ib], with_scale)
    rpe_t, rpe_r = rpe(est, gt, 1, max_dt)
    return {
        "ate_rmse": rmse,
        "ate_mean": float(err.mean()),
        "ate_median": float(np.median(err)),
        "ate_max": float(err.max()),
        "n_pairs": int(ia.size),
        "rpe_trans": rpe_t,
        "rpe_rot": rpe_r,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Command line: ATE/RPE of a TUM trace against ground truth, printed
    as one JSON object."""
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="ATE/RPE of a TUM trace vs ground truth")
    ap.add_argument("est", help="estimated trajectory (TUM format)")
    ap.add_argument("gt", help="ground-truth trajectory (TUM format)")
    ap.add_argument("--max-dt", type=float, default=0.02)
    ap.add_argument("--scale", action="store_true", help="Sim(3) alignment")
    a = ap.parse_args(argv)
    out = evaluate_ate(load_tum(a.est), load_tum(a.gt), a.max_dt, a.scale)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
