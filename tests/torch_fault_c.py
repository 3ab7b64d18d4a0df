"""Where the chained JAX and port runs of the 8,192-ray sequence part on
frame 2 (ROADMAP queue 3 item 9).  A script, not a test (~2 minutes on a
CPU):

    JAX_PLATFORMS=cpu python tests/torch_fault_c.py

The sequence and configuration are tests/torch_triangle_gap.py's (seed 0).
Both pipelines run frames 0 and 1 chained, each on its own state.  Frame 2's
LIO step is then replayed on the port, one ESIKF iteration at a time, from:
  (a) the reference's state and plane map after frame 1,
  (b) the port's own (the chained run),
  (c) the reference's filter state with the port's plane map, and
  (d) the port's filter state with the reference's plane map,
logging per iteration the convergence test's values (|δθ| in degrees,
|δp| in m), the number of associated points and the pose.  The reference's
own frame-2 pose (its jitted step, from (a)) is printed beside them.

Then, for the first iteration whose association differs between (a) and
(b), every point that is associated on one side only: its world position,
its plane-map voxel, its distance to the nearest voxel face, and both
sides' gate values |z| and sigma_num·sqrt(σ²), each also evaluated in f64
on that side's f32 inputs — which shows whether a side's f32 rounding
crosses the gate, or the two sides' inputs already lie on either side.
The deskew twist and downsampled points of (a) and (b) are compared too,
since the constant-twist deskew reads the previous frame's posterior.

Last, the two plane maps after frame 1: the voxels whose normals differ
most, frame 2 replayed with the reference's plane put into the port's map
one voxel at a time, and each voxel's fit — stored, refitted by the port
from the reference's moments, by the reference's own plane_from_moments
op by op (jax.disable_jit) and under jax.jit, and in f64 — with the terms
of eigh3x3's trigonometric eigenvalues (q, p, r = det(B)/2, 1 − |r|).
"""

import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import immesh_tpu.runtime.joint as jjoint  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from immesh_tpu.lio.pipeline import lio_step as jlio_step  # noqa: E402
import immesh_tpu_torch.runtime.joint as tjoint  # noqa: E402
from immesh_tpu.frontend.sim import (  # noqa: E402
    ForwardTrajectory, LidarImuSimulator, outdoor_scene)
from immesh_tpu.frontend.types import ScanBundle as JBundle  # noqa: E402
from immesh_tpu_torch import interop  # noqa: E402
from immesh_tpu_torch.config import ImMeshConfig as TConfig  # noqa: E402
from immesh_tpu_torch.core.state import STATE_DIM  # noqa: E402
from immesh_tpu_torch.frontend.types import ScanBundle as TBundle  # noqa: E402
from immesh_tpu_torch.lio import association as tassoc  # noqa: E402
from immesh_tpu_torch.lio.downsample import voxel_downsample  # noqa: E402
from immesh_tpu_torch.lio.pipeline import propagate_and_deskew  # noqa: E402
from immesh_tpu_torch.map.voxel_map import _sym_unpack  # noqa: E402
from immesh_tpu_torch.core.geometry import lidar_point_cov_body  # noqa: E402
from torch_triangle_gap import N_RAYS, config, tree  # noqa: E402

PART_FRAME = 2


def sequence():
    return LidarImuSimulator(scene=outdoor_scene(length=400.0),
                             traj=ForwardTrajectory(speed=9.0), n_rays=N_RAYS,
                             rings=16, max_range=120.0, seed=0)


def bundle_args(f, cfg):
    return (f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
            f.scan_duration, N_RAYS, cfg.imu.max_imu_per_scan)


def replay(state, vm, bundle, cfg):
    """Frame `bundle`'s LIO update on the port, one iteration at a time, as
    lio/esikf.iterated_update runs it.  Returns the per-iteration log and
    the associations."""
    lio_cfg, map_cfg = cfg.lio, cfg.voxel_map
    state_prop, pts_end = propagate_and_deskew(state, bundle, bundle.pts,
                                               cfg.imu)
    down, dmask = voxel_downsample(pts_end, bundle.mask,
                                   lio_cfg.downsample_voxel,
                                   lio_cfg.map_update_points)
    pcov = lidar_point_cov_body(down, map_cfg.dept_err, map_cfg.beam_err)
    eye = torch.eye(STATE_DIM)
    p_inv = torch.linalg.inv(state_prop.cov + eye * 1e-9)
    st, log, assocs = state_prop, [], []
    for it in range(lio_cfg.max_iterations):
        a = tassoc.associate(st, vm, down, pcov, dmask, map_cfg)
        hw = a["h6"] * a["r_inv"][:, None]
        A = p_inv.clone()
        A[0:6, 0:6] += hw.T @ a["h6"]
        b = p_inv @ state_prop.boxminus(st)
        b[0:6] += hw.T @ (-a["z"])
        delta = torch.cholesky_solve(
            b[:, None], torch.linalg.cholesky(A + eye * 1e-9))[:, 0]
        assocs.append((st, a))
        st = st.boxplus(delta)
        rot = float(torch.linalg.norm(delta[0:3])) * 180 / np.pi
        trans = float(torch.linalg.norm(delta[3:6]))
        log.append({"it": it, "rot_deg": rot, "trans_m": trans,
                    "n": int(a["valid"].sum()), "pos": st.pos.numpy().copy(),
                    "conv": rot < lio_cfg.converge_rot_deg
                    and trans < lio_cfg.converge_trans_m})
        if log[-1]["conv"]:
            break
    return {"log": log, "assocs": assocs, "down": down, "dmask": dmask,
            "pcov": pcov, "state_prop": state_prop,
            "twist": (state.bg.numpy().copy(), state.vel.numpy().copy())}


def gate_f64(st, vm, q_pts, pcov, slot, cfg):
    """|z| and sigma_num·sqrt(σ²) of associate() in f64 on these f32 inputs."""
    sl = slot.long()
    n = vm.normal[sl].double()
    q = st.transform_points(q_pts).double()
    z = (n * q).sum(-1) + vm.d[sl].double()
    m = n @ st.rot.double()
    qc = q - vm.center[sl].double()
    cov_nn = _sym_unpack(vm.cov_nn[sl]).double()
    s2 = (torch.einsum("ni,nij,nj->n", qc, cov_nn, qc) + vm.var_c[sl].double()
          + torch.einsum("ni,nij,nj->n", m, pcov.double(), m)).clamp(min=1e-9)
    return z.abs(), cfg.sigma_num * torch.sqrt(s2)


def gate_f32(st, vm, q_pts, pcov, slot, cfg):
    sl = slot.long()
    n = vm.normal[sl]
    q = st.transform_points(q_pts)
    z = torch.sum(n * q, dim=-1) + vm.d[sl]
    m = n @ st.rot
    qc = q - vm.center[sl]
    cov_nn = _sym_unpack(vm.cov_nn[sl])
    s2 = torch.clamp(torch.einsum("ni,nij,nj->n", qc, cov_nn, qc)
                     + vm.var_c[sl] + torch.einsum("ni,nij,nj->n", m, pcov, m),
                     min=1e-9)
    return z.abs(), cfg.sigma_num * torch.sqrt(s2)


def main():
    cfg = config()
    tcfg = TConfig.from_dict(cfg.to_dict())
    sim = sequence()
    jp = jjoint.JointPipeline(cfg, adaptive_mesh_budget=256,
                              adaptive_threshold=600)
    tp = tjoint.JointPipeline(tcfg, adaptive_mesh_budget=256,
                              adaptive_threshold=600, device="cpu")
    for k in range(PART_FRAME):
        f = sim.frame(k)
        jp.step(JBundle.from_numpy(*bundle_args(f, cfg)))
        tp.step(TBundle.from_numpy(*bundle_args(f, cfg), device="cpu"))
        print(f"frame {k}: |Δpos| chained "
              f"{np.abs(tp.state.pos.numpy() - np.asarray(jp.state.pos)).max():.3e} m")
    ref = interop.from_reference({"state": tree(jp.lio.state),
                                  "vm": tree(jp.lio.vm)}, tcfg, device="cpu")
    own = {"state": tp.lio.state, "vm": tp.lio.vm}
    f = sim.frame(PART_FRAME)
    tb = TBundle.from_numpy(*bundle_args(f, cfg), device="cpu")
    jb = JBundle.from_numpy(*bundle_args(f, cfg))
    js, jvm = jax.tree_util.tree_map(jnp.copy, (jp.lio.state, jp.lio.vm))
    jp.step(jb)
    j_pos = np.asarray(jp.state.pos)
    print(f"\nframe {PART_FRAME} on the reference, from its own state: "
          f"lio_step compiled with max_iterations = k stops after iteration k")
    for k in range(1, cfg.lio.max_iterations + 1):
        ck = cfg.replace(lio=dataclasses.replace(cfg.lio, max_iterations=k))
        st, _, _, dg = jlio_step(js, jvm, jb, ck)
        print(f"   it {k - 1}: associated {int(dg['n_effective'])}, converged "
              f"{bool(dg['converged'])}, pos {np.asarray(st.pos)}")
        if bool(dg["converged"]):
            break

    runs = {"a ref state+map": (ref["state"], ref["vm"]),
            "b own state+map": (own["state"], own["vm"]),
            "c ref state, own map": (ref["state"], own["vm"]),
            "d own state, ref map": (own["state"], ref["vm"])}
    out = {}
    print(f"\nframe {PART_FRAME}: the reference's jitted step from (a) ends at "
          f"pos {j_pos}")
    for name, (st, vm) in runs.items():
        r = out[name] = replay(st, vm, tb, tcfg)
        print(f"({name}): twist |Δ| vs (a) "
              + (f"bg {np.abs(r['twist'][0] - out['a ref state+map']['twist'][0]).max():.2e}, "
                 f"vel {np.abs(r['twist'][1] - out['a ref state+map']['twist'][1]).max():.2e}"
                 if name[0] != "a" else "-"))
        for e in r["log"]:
            print(f"   it {e['it']}: |δθ| {e['rot_deg']:.3e} deg, |δp| "
                  f"{e['trans_m']:.3e} m, associated {e['n']}, converged "
                  f"{e['conv']}, |pos − ref jit| "
                  f"{np.abs(e['pos'] - j_pos).max():.3e} m")

    a, b = out["a ref state+map"], out["b own state+map"]
    same_down = torch.equal(a["dmask"], b["dmask"])
    dd = (a["down"] - b["down"])[a["dmask"] & b["dmask"]].abs().max()
    print(f"\ndownsampled points: masks equal {same_down}, "
          f"{int(a['dmask'].sum())} / {int(b['dmask'].sum())} kept, max |Δ| "
          f"{float(dd):.3e} m")
    vm_a, vm_b = runs["a ref state+map"][1], runs["b own state+map"][1]
    for it in range(min(len(a["assocs"]), len(b["assocs"]))):
        (sa, xa), (sb, xb) = a["assocs"][it], b["assocs"][it]
        diff = torch.nonzero(xa["valid"] != xb["valid"])[:, 0]
        print(f"iteration {it}: association differs at {len(diff)} points "
              f"(slots differ at "
              f"{int(((xa['slot'] != xb['slot']) & xa['valid'] & xb['valid']).sum())}"
              f" points associated on both)")
        if len(diff) == 0:
            continue
        size = tcfg.voxel_map.voxel_size
        for i in diff[:8].tolist():
            line = [f"  point {i}:"]
            for tag, st, x, vm, r in (("a", sa, xa, vm_a, a), ("b", sb, xb, vm_b, b)):
                q = st.transform_points(r["down"][i:i + 1])[0]
                qs = q / size
                face = float(((qs - torch.floor(qs)).clamp(0, 1) - 0.5).abs().max())
                face = (0.5 - face) * size
                s = x["slot"][i:i + 1]
                z32, g32 = gate_f32(st, vm, r["down"][i:i + 1],
                                    r["pcov"][i:i + 1], s, tcfg.voxel_map)
                z64, g64 = gate_f64(st, vm, r["down"][i:i + 1],
                                    r["pcov"][i:i + 1], s, tcfg.voxel_map)
                line.append(
                    f"{tag}: valid {bool(x['valid'][i])}, q {q.numpy()}, voxel "
                    f"{torch.floor(qs).int().tolist()}, nearest face "
                    f"{face:.3e} m, slot {int(s)}, |z| {float(z32):.6e} vs gate "
                    f"{float(g32):.6e} (f32), {float(z64):.6e} vs "
                    f"{float(g64):.6e} (f64)")
            print("\n    ".join(line))
        break
    compare_maps(tcfg, vm_a, vm_b, tb, runs, j_pos)


def compare_maps(tcfg, vm_a, vm_b, tb, runs, j_pos):
    """The plane maps after frame 1: which voxels differ, and which of them
    moves frame 2's pose (the reference's plane put into the port's map one
    voxel at a time)."""
    same_keys = torch.equal(vm_a.table.keys, vm_b.table.keys)
    cnt = (vm_a.count != vm_b.count)
    pv = (vm_a.plane_valid != vm_b.plane_valid)
    sub = (vm_a.subdivided != vm_b.subdivided)
    dn = (vm_a.normal - vm_b.normal).abs().amax(-1)
    dn = torch.where(vm_a.plane_valid & vm_b.plane_valid, dn,
                     torch.zeros_like(dn))
    print(f"\nplane maps after frame {PART_FRAME - 1}: keys equal {same_keys}, "
          f"counts differ in {int(cnt.sum())} voxels, plane_valid in "
          f"{int(pv.sum())}, subdivided in {int(sub.sum())}; largest "
          f"|Δnormal| {float(dn.max()):.3e}")
    order = torch.argsort(dn, descending=True)[:6].tolist()
    st_a = runs["a ref state+map"][0]
    for sl in order:
        lam_a, lam_b = vm_a.lam[sl].numpy(), vm_b.lam[sl].numpy()
        trial = dataclasses.replace(vm_b, **{
            k: getattr(vm_b, k).clone() for k in vm_b._FIELDS})
        for k in trial._FIELDS:
            getattr(trial, k)[sl] = getattr(vm_a, k)[sl]
        r = replay(st_a, trial, tb, tcfg)
        gap = np.abs(r["log"][-1]["pos"] - j_pos).max()
        key = vm_a.table.keys[sl].tolist()
        fits = fit_evidence(vm_a, vm_b, sl, tcfg)
        print(f"  slot {sl} key {key}: |Δnormal| {float(dn[sl]):.3e}, count "
              f"{float(vm_a.count[sl]):.0f}/{float(vm_b.count[sl]):.0f}, lam "
              f"{lam_a} / {lam_b}, |Δsum_p| "
              f"{float((vm_a.sum_p[sl] - vm_b.sum_p[sl]).abs().max()):.3e}, "
              f"|Δsum_ppT| "
              f"{float((vm_a.sum_ppT[sl] - vm_b.sum_ppT[sl]).abs().max()):.3e}"
              f"; frame {PART_FRAME} gap with the reference's plane here: "
              f"{gap:.3e} m\n    " + "\n    ".join(fits))


def _angle(n1, n2):
    c = abs(float((n1.double() * n2.double()).sum()))
    return float(np.degrees(np.arccos(min(1.0, c))))


def trig_terms(sum_p, sum_ppT, count, xp):
    """The first half of eigh3x3 on plane_from_moments' covariance, written
    as the reference writes it, for `xp` = jax.numpy or torch (f64)."""
    n = count[..., None]
    mean = sum_p / n
    cov = sum_ppT / n[..., None] - mean[..., :, None] * mean[..., None, :]
    cov = 0.5 * (cov + xp.swapaxes(cov, -1, -2))
    a00, a11, a22 = cov[..., 0, 0], cov[..., 1, 1], cov[..., 2, 2]
    a01, a02, a12 = cov[..., 0, 1], cov[..., 0, 2], cov[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = xp.sqrt(p2 / 6.0)
    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detB = (b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = detB / 2.0
    lam_min = q + 2.0 * p * xp.cos(xp.arccos(r) / 3.0 + 2.0 * np.pi / 3.0)
    return {"cov00": a00, "q": q, "p": p, "r": r, "1-|r|": 1.0 - xp.abs(r),
            "lam_min": lam_min}


def reference_refit(vm, sl, tcfg):
    """The reference's own plane_from_moments on its stored moments of one
    voxel, op by op (eager) and compiled (jax.jit): which of the two
    reproduces its stored fit."""
    from immesh_tpu.core.geometry import plane_from_moments as jfit
    from immesh_tpu.map.voxel_map import _sym_unpack as jsym
    from immesh_tpu_torch.map.voxel_map import _key_centers
    anchor = _key_centers(vm.table.keys[sl:sl + 1], tcfg.voxel_map.voxel_size,
                          torch.float32).numpy()
    args = (jnp.asarray(vm.sum_p[sl:sl + 1].numpy()),
            jsym(jnp.asarray(vm.sum_ppT[sl:sl + 1].numpy())),
            jnp.asarray(vm.count[sl:sl + 1].numpy()),
            jnp.asarray((vm.sigma2_sum[sl:sl + 1]
                         / vm.count[sl:sl + 1]).numpy()),
            5, jnp.asarray(anchor))
    with jax.disable_jit():
        eager = jfit(*args)
    jitted = jax.jit(jfit, static_argnums=4)(*args)
    n_st = vm.normal[sl]
    terms = [trig_terms(args[0], args[1], args[2], jnp),
             jax.jit(lambda a, b, c: trig_terms(a, b, c, jnp))(*args[:3])]
    with jax.disable_jit():
        terms[0] = trig_terms(*args[:3], jnp)
    n64 = torch.from_numpy(np.asarray(args[2], np.float64))
    t64 = trig_terms(torch.from_numpy(np.asarray(args[0], np.float64)),
                     torch.from_numpy(np.asarray(args[1], np.float64)), n64,
                     torch)
    rows = []
    for name, t in (("eager", terms[0]), ("jit", terms[1]), ("f64", t64)):
        rows.append(f"{name}: " + ", ".join(
            f"{k} {float(np.asarray(v).reshape(-1)[0]):.9e}"
            for k, v in t.items()))
    return (f"trig eigenvalue terms of eigh3x3 (cov = Σppᵀ/n − μμᵀ, "
            f"q, p, r = det(B)/2, 1 − |r|, λ_min = q + 2p·cos(acos(r)/3 + "
            f"2π/3)):\n      " + "\n      ".join(rows) + "\n    "
            f"reference plane_from_moments on these moments: eager lam "
            f"{np.asarray(eager['lam'][0])} (normal "
            f"{_angle(torch.from_numpy(np.asarray(eager['normal'][0])), n_st):.3f}"
            f" deg from stored), jit lam {np.asarray(jitted['lam'][0])} "
            f"(normal "
            f"{_angle(torch.from_numpy(np.asarray(jitted['normal'][0])), n_st):.3f}"
            f" deg from stored)")


def fit_evidence(vm_a, vm_b, sl, tcfg):
    """The plane fit of one voxel: each side's stored f32 fit, the port's f32
    fit of the reference's moments, and an f64 fit (the same moment formula,
    LAPACK eigh) of each side's f32 moments."""
    from immesh_tpu_torch.core.geometry import plane_from_moments
    from immesh_tpu_torch.map.voxel_map import _key_centers
    out = []
    f64 = {}
    for tag, vm in (("ref", vm_a), ("port", vm_b)):
        key = vm.table.keys[sl:sl + 1]
        anchor = _key_centers(key, tcfg.voxel_map.voxel_size, torch.float32)
        n = vm.count[sl].double()
        mean = vm.sum_p[sl].double() / n
        cov = (_sym_unpack(vm.sum_ppT[sl]).double() / n
               - mean[:, None] * mean[None, :])
        lam, vec = torch.linalg.eigh(cov)
        f64[tag] = vec[:, 0]
        refit = plane_from_moments(vm.sum_p[sl:sl + 1],
                                   _sym_unpack(vm.sum_ppT[sl:sl + 1]),
                                   vm.count[sl:sl + 1],
                                   vm.sigma2_sum[sl:sl + 1] / vm.count[sl:sl + 1],
                                   anchor=anchor)
        out.append(
            f"{tag} moments: stored f32 lam {vm.lam[sl].numpy()}, normal "
            f"{vm.normal[sl].numpy()}; port f32 refit lam "
            f"{refit['lam'][0].numpy()} (normal {_angle(refit['normal'][0], vm.normal[sl]):.3f} "
            f"deg from stored); f64 lam {lam.numpy()}, f64 normal "
            f"{_angle(vec[:, 0], vm.normal[sl]):.3f} deg from stored")
    out.append(reference_refit(vm_a, sl, tcfg))
    out.append(f"f64 normals of the two sides' moments differ by "
               f"{_angle(f64['ref'], f64['port']):.3f} deg; stored f32 "
               f"normals by {_angle(vm_a.normal[sl], vm_b.normal[sl]):.3f} deg")
    return out


if __name__ == "__main__":
    main()
