"""Bundle adjustment over a torch.distributed process group in the PyTorch
port (parallel/sharded_ba.py, point_sharded_ba.py) against the JAX
package's sharded solves on its 8-device CPU mesh, and the port's System
with use_mesh=True against JAX's.

The in-process cases run over a one-rank gloo group; two ranks run as two
spawned processes meeting through a file store: the solves through
anyfeature_vslam_tpu_torch/parallel/rank_worker.py, the System (use_mesh
"auto" over the two-rank group) through tests/torch_mesh_system_worker.py.

Tolerances and why (those of tests/test_sharded_ba.py and
tests/test_point_sharded_ba.py):
- partition_by_point / unpartition exactly equal to JAX's (numpy host
  code);
- sharded poses within 5e-4 and points within 5e-3 of JAX's sharded
  result (float32 CG with other summation orders; the split of the sums
  over ranks moves their order again); point-sharded chi2 within 2e-2
  relative + 5e-2 absolute;
- at one rank, the sharded solve equal bit for bit to the port's
  unsharded CG solve (the all-reduce of one rank is the identity), and the
  two ranks' outputs equal to each other (every rank holds the summed
  camera blocks);
- the 12-frame System, on one rank and on two: tests/test_torch_system.py's
  bounds (the same initialization, counts within 10%, >= 60% of JAX's
  keyframes at the same frames with centres within 1e-2 and rotations
  within 1e-2 rad, both trajectories within 1 cm of the truth); the two
  ranks' maps equal to each other, bit for bit;
- ranks that track different frames raise at their first sharded solve
  (Mesh.check_same) instead of summing each other's problems.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from threadpoolctl import threadpool_limits

from anyfeature_vslam_tpu.ops.camera import CameraParams as JaxCamera
from anyfeature_vslam_tpu.parallel import point_sharded_ba as jpsh
from anyfeature_vslam_tpu.parallel import sharded_ba as jsh
from anyfeature_vslam_tpu.system import System as JaxSystem
from anyfeature_vslam_tpu_torch.io import evaluation
from anyfeature_vslam_tpu_torch.ops import ba as tba
from anyfeature_vslam_tpu_torch.parallel import point_sharded_ba as tpsh
from anyfeature_vslam_tpu_torch.parallel import sharded_ba as tsh
from anyfeature_vslam_tpu_torch.system import System
from test_ba import CX, CY, FX, FY, reproj_rmse, synth_ba
from test_sharded_ba import _pad_obs
from torch_slice_scene import SliceScene

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
KEYS = ("obs_kf", "obs_pt", "obs_uv", "obs_w", "obs_valid")
W, H, N_FEATURES, N_PARITY = 320, 240, 600, 12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo group in this process (the default group), closed
    after the module."""
    m = tsh.make_mesh("cpu")
    yield m
    m.close()


def _problem(seed, pad=8):
    _, _, poses_n, pts_n, obs = synth_ba(seed=seed)
    if pad:
        obs = _pad_obs(obs, pad)
    free = np.ones(len(poses_n), bool)
    free[0] = False
    return poses_n, pts_n, free, obs


def _args(prob, to):
    poses, pts, free, obs = prob
    return (to(poses), to(pts), to(free), *(to(obs[k]) for k in KEYS), FX, FY, CX, CY)


@pytest.fixture(scope="module")
def jax_results():
    """JAX's solves on its 8-device mesh: sharded (seed 5, 8 iterations),
    the sharded two-stage schedule, and point-sharded (seed 7)."""
    p5, p7 = _problem(5), _problem(7, pad=0)
    a5 = _args(p5, jnp.asarray)
    poses, pts, free, obs = p7
    return dict(
        sharded=[np.asarray(t) for t in jsh.sharded_bundle_adjust(jsh.make_mesh(8), *a5,
                                                                  n_iters=8)],
        two_stage=[np.asarray(t) for t in jsh.sharded_bundle_adjust_two_stage(
            jsh.make_mesh(8), *a5)],
        point=jpsh.global_ba_point_sharded(poses, pts, free, *(obs[k] for k in KEYS),
                                           FX, FY, CX, CY, mesh=jpsh.make_mesh(8), n_iters=8))


@pytest.mark.parametrize("n_dev,n_pts,n_obs", [(8, 37, 100), (2, 150, 900), (3, 10, 0),
                                               (1, 5, 40)])
def test_partition_equals_jax(n_dev, n_pts, n_obs):
    rng = np.random.default_rng(n_dev)
    pts = rng.normal(size=(n_pts, 3)).astype(np.float32)
    kf = rng.integers(0, 5, n_obs).astype(np.int32)
    pt = rng.integers(0, n_pts, n_obs).astype(np.int32)
    uv = rng.normal(size=(n_obs, 2)).astype(np.float32)
    w = rng.random(n_obs).astype(np.float32)
    valid = rng.random(n_obs) < 0.9
    t = tpsh.partition_by_point(pts, kf, pt, uv, w, valid, n_dev)
    j = jpsh.partition_by_point(pts, kf, pt, uv, w, valid, n_dev)
    np.testing.assert_array_equal(t[0], j[0])
    assert t[1].keys() == j[1].keys()
    for k in t[1]:
        assert t[1][k].dtype == j[1][k].dtype
        np.testing.assert_array_equal(t[1][k], j[1][k])
    np.testing.assert_array_equal(t[2], j[2])
    vals = rng.normal(size=(len(t[2]), 2)).astype(np.float32)
    np.testing.assert_array_equal(tpsh.unpartition(vals, t[2], n_obs, fill=-1.0),
                                  jpsh.unpartition(vals, j[2], n_obs, fill=-1.0))


def test_one_rank_sharded_against_jax(mesh, jax_results):
    prob = _problem(5)
    args = _args(prob, torch.from_numpy)
    p, x, c, z = tsh.sharded_bundle_adjust(mesh, *args, n_iters=8)
    jp, jx, jc, jz = jax_results["sharded"]
    np.testing.assert_allclose(p.numpy(), jp, atol=5e-4)
    np.testing.assert_allclose(x.numpy(), jx, atol=5e-3)
    assert c.shape == z.shape == (len(prob[3]["obs_kf"]),)
    orig = len(synth_ba(seed=5)[4]["obs_kf"])  # the rows before the padding
    assert reproj_rmse(p.numpy(), x.numpy(), {k: v[:orig] for k, v in prob[3].items()}) < 0.6
    # one rank: the unsharded CG solve, bit for bit
    for a, b in zip((p, x, c, z), tba._bundle_adjust_impl(*args, n_iters=8)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    p2, x2, c2, z2, v2 = tsh.sharded_bundle_adjust_two_stage(mesh, *args)
    jp2, jx2, _, _, jv2 = jax_results["two_stage"]
    np.testing.assert_allclose(p2.numpy(), jp2, atol=5e-4)
    np.testing.assert_allclose(x2.numpy(), jx2, atol=5e-3)
    np.testing.assert_array_equal(v2.numpy(), jv2)
    n_obs = len(prob[3]["obs_kf"])
    with pytest.raises(ValueError, match="divisible"):
        tsh.sharded_bundle_adjust(tsh.Mesh(size=n_obs + 1, rank=0, device=torch.device("cpu")),
                                  *args, n_iters=1)


def _check_point(result, jax_point, obs):
    p, x, c, _ = result
    jp, jx, jc, _ = jax_point
    np.testing.assert_allclose(p, jp, atol=5e-4)
    np.testing.assert_allclose(x, jx, atol=5e-3)
    valid = obs["obs_valid"]
    np.testing.assert_allclose(c[valid], jc[valid], rtol=2e-2, atol=5e-2)


def test_one_rank_point_sharded_against_jax(mesh, jax_results):
    prob = _problem(7, pad=0)
    res = tpsh.global_ba_point_sharded(*_args(prob, torch.from_numpy), mesh=mesh, n_iters=8)
    assert res[1].shape == prob[1].shape and res[2].shape == (len(prob[3]["obs_kf"]),)
    _check_point(res, jax_results["point"], prob[3])


def _spawn_ranks(arg_lists, timeout=240):
    """Run `python <args>` once per rank from the repository root, one torch
    thread each; returns each rank's (exit code, output)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, *args], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for args in arg_lists]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return [(p.returncode, log) for p, log in zip(procs, logs)]


def test_two_ranks_in_two_processes(tmp_path, jax_results):
    """Two gloo ranks in two spawned processes: the observation-sharded,
    two-stage and point-sharded solves against JAX's 8-device results, and
    the two ranks' outputs equal."""
    prob_path = str(tmp_path / "prob.npz")
    results = {}
    for seed, pad, solves in ((5, 8, "obs,two_stage"), (7, 0, "point")):
        poses, pts, free, obs = _problem(seed, pad)
        np.savez(prob_path, poses=poses, pts=pts, kf_free=free, **obs,
                 intr=np.array([FX, FY, CX, CY]), n_iters=8, solves=solves)
        store = str(tmp_path / f"store{seed}")
        outs = [str(tmp_path / f"out{seed}_{r}.npz") for r in range(2)]
        for r, (code, log) in enumerate(_spawn_ranks(
                [["-m", "anyfeature_vslam_tpu_torch.parallel.rank_worker", prob_path, str(r), "2",
                  store, "cpu", outs[r]] for r in range(2)])):
            assert code == 0, f"rank {r}:\n{log[-3000:]}"
        results[seed] = [dict(np.load(o)) for o in outs]
        r0, r1 = results[seed]
        for k in r0:
            if not k.startswith("ms_"):
                np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    r = results[5][0]
    jp, jx, _, _ = jax_results["sharded"]
    np.testing.assert_allclose(r["poses"], jp, atol=5e-4)
    np.testing.assert_allclose(r["pts"], jx, atol=5e-3)
    jp2, jx2, _, _, jv2 = jax_results["two_stage"]
    np.testing.assert_allclose(r["ts_poses"], jp2, atol=5e-4)
    np.testing.assert_allclose(r["ts_pts"], jx2, atol=5e-3)
    np.testing.assert_array_equal(r["ts_valid"], jv2)
    r = results[7][0]
    _check_point((r["ps_poses"], r["ps_pts"], r["ps_chi2"], r["ps_z"]), jax_results["point"],
                 _problem(7, pad=0)[3])


def _run(system, frames):
    rows = []
    for i, img in enumerate(frames):
        state = system.track_monocular(img, i / 30.0)
        rows.append((state.name, system.map.n_keyframes(), system.map.n_points()))
    m = system.map
    poses = {int(m.kf_frame_id[k]): m.kf_pose[k].copy() for k in m.keyframe_ids()}
    return rows, poses, dict(system.tracker.stats)


def _centre(t):
    t = t.astype(np.float64)
    return -t[:3, :3].T @ t[:3, 3]


MESH_KW = dict(feature="orb32", n_features=N_FEATURES, enable_loop_closing=False,
               async_mapping=False, use_mesh=True)


@pytest.fixture(scope="module")
def scene_frames():
    sc = SliceScene(W, H)
    return sc, [sc.render(i)[0] for i in range(N_PARITY)]


@pytest.fixture(scope="module")
def jax_mesh_run(scene_frames):
    """JAX's System over the 12 frames with use_mesh=True (every local BA
    sharded over its 8 devices)."""
    sc, frames = scene_frames
    return _run(JaxSystem(JaxCamera.create(**sc.camera), **MESH_KW), frames)


def _check_against_jax(port_run, jax_run, sc):
    (trows, tposes, tstats), (jrows, jposes, jstats) = port_run, jax_run

    def init(rows):
        i = next(k for k, r in enumerate(rows) if r[0] == "OK")
        return i, rows[i][2]

    assert init(trows) == init(jrows)
    for k in (1, 2):
        assert abs(trows[-1][k] - jrows[-1][k]) <= 0.1 * jrows[-1][k], (trows[-1], jrows[-1])
    assert tstats["resets"] == jstats["resets"] == 0
    assert tstats["lost_frames"] == jstats["lost_frames"] == 0
    common = sorted(set(jposes) & set(tposes))
    assert len(common) >= 0.6 * len(jposes), (sorted(jposes), sorted(tposes))
    for fid in common:
        a, b = tposes[fid].astype(np.float64), jposes[fid].astype(np.float64)
        r = a[:3, :3] @ b[:3, :3].T
        w = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
        rot = np.arctan2(0.5 * np.linalg.norm(w), 0.5 * (np.trace(r) - 1))
        assert np.linalg.norm(_centre(a) - _centre(b)) < 1e-2 and rot < 1e-2, (fid, rot)
    for poses in (jposes, tposes):
        est = np.stack([_centre(p) for p in poses.values()])
        gt = np.stack([_centre(sc.poses[f]) for f in poses])
        assert evaluation.ate_rmse(est, gt)[0] < 0.01


def test_system_with_mesh_against_jax(mesh, scene_frames, jax_mesh_run):
    """12 synchronous frames at 320x240 with use_mesh=True in both
    packages: every local BA sharded (JAX over its 8 devices, the port over
    the one-rank group), so both solve with CG."""
    sc, frames = scene_frames
    tsys = System(SimpleNamespace(**sc.camera), device="cpu", **MESH_KW)
    assert tsys.mesh is not None and tsys.mesh.size == 1 and tsys.local_mapper.mesh is tsys.mesh
    port_run = _run(tsys, frames)
    log = tsys.local_mapper.ba_log
    assert log and all(b["mesh"] == 1 and not b["dense"] for b in log)
    arrays, info = tsys.local_mapper.last_ba_problem
    assert info["o_cap"] == log[-1]["o_cap"] and len(arrays) == 8
    assert arrays[3].shape == (info["o_cap"],) and int(arrays[7].sum()) == info["n_obs"]
    _check_against_jax(port_run, jax_mesh_run, sc)
    tsys.shutdown()
    assert torch.distributed.is_initialized()  # the fixture's group, not the System's


def _mesh_system_ranks(tmp_path, firsts):
    store = str(tmp_path / "store_system")
    outs = [str(tmp_path / f"system_{r}.npz") for r in range(2)]
    res = _spawn_ranks([[os.path.join(HERE, "torch_mesh_system_worker.py"), str(r), "2", store,
                         str(first), str(N_PARITY), outs[r]] for r, first in enumerate(firsts)])
    return res, outs


def test_system_on_two_ranks(tmp_path, scene_frames, jax_mesh_run):
    """The System with use_mesh="auto" in two spawned gloo ranks over the
    same 12 frames: every local BA sharded over both, the two maps equal
    bit for bit, and rank 0 against JAX's use_mesh=True System."""
    res, outs = _mesh_system_ranks(tmp_path, (0, 0))
    for r, (code, log) in enumerate(res):
        assert code == 0, f"rank {r}:\n{log[-3000:]}"
    r0, r1 = (dict(np.load(o)) for o in outs)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert len(r0["ba_mesh"]) and (r0["ba_mesh"] == 2).all() and not r0["ba_dense"].any()
    rows = [(str(n), int(c[0]), int(c[1])) for n, c in zip(r0["names"], r0["counts"])]
    poses = {int(f): p for f, p in zip(r0["kf_frame"], r0["kf_pose"])}
    stats = dict(resets=int(r0["resets"]), lost_frames=int(r0["lost"]))
    _check_against_jax((rows, poses, stats), jax_mesh_run, scene_frames[0])


def test_system_ranks_on_different_frames_raise(tmp_path):
    """Two ranks whose Systems track different frames (rank 1 one frame
    later) stop at their first sharded solve with the problems' mismatch,
    both of them, instead of summing each other's Hessians."""
    res, _ = _mesh_system_ranks(tmp_path, (0, 1))
    for r, (code, log) in enumerate(res):
        assert code != 0 and "BA problems differ" in log, f"rank {r}:\n{log[-3000:]}"
