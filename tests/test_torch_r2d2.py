"""The precomputed-feature family r2d2_128 in the PyTorch port against the
JAX package: the loader (io/precomputed.py), both synchronous Systems fed
through ``track_monocular(img, ts, image_path=...)``, and the port's
``run_sequence`` on the CPU. The r2d2 file tree is written here with
numpy (tests/r2d2_scene.py: landmarks with fixed descriptors seen by a
translating camera, flat gray images).

Tolerances and why:
- the loader: exactly equal (the same numpy code on the same files);
- the Systems: the same features on both sides (loaded, not extracted),
  so the same initialization frame and map; the runs then differ only by
  float32 BA and search sums in another order (ROADMAP.md section 3), so
  the checks are tests/torch_system_parity.py's: initial points within
  1%, keyframe and point counts within 25% at the last frame, no frame
  lost, no reset.
"""

import os

import numpy as np
import pytest
import torch

from anyfeature_vslam_tpu.io import precomputed as jpre
from anyfeature_vslam_tpu_torch.io import precomputed as tpre
from r2d2_scene import R2d2Scene

W, H, N_FRAMES, N_PTS = 320, 240, 10, 600


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One thread for torch's intra-op pool and the BLAS pools (numpy's host
    linear algebra in both packages): the suite's workers share the host's
    cores."""
    from threadpoolctl import threadpool_limits

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(n_threads)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("r2d2_seq"))
    sc = R2d2Scene(W, H, n_frames=N_FRAMES, n_pts=N_PTS)
    return sc, root, sc.write(root, write_png=True)


@pytest.mark.parametrize("capacity", [100, 600, 2000])
def test_load_precomputed_features_matches_jax(scene, capacity):
    _, _, paths = scene
    for path in (paths[0], paths[-1]):
        want = jpre.load_precomputed_features(path, capacity)
        got = tpre.load_precomputed_features(path, capacity)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k])
    assert tpre.feature_paths(paths[3]) == jpre.feature_paths(paths[3])


def test_missing_image_path_or_files_raise(scene):
    from anyfeature_vslam_tpu_torch.system import System

    sc, root, paths = scene
    system = System(dict_camera(sc), feature="r2d2_128", n_features=N_PTS, device="cpu",
                    async_mapping=False)
    assert system.tracker.extractor is None and system.tracker.extractor_init is None
    with pytest.raises(ValueError, match="image path"):
        system.track_monocular(sc.image(), 0.0)
    with pytest.raises(FileNotFoundError):
        system.track_monocular(sc.image(), 0.0, image_path=os.path.join(root, "rgb", "x.png"))


def dict_camera(sc):
    from types import SimpleNamespace

    return SimpleNamespace(**sc.camera)


def _run(system, sc, paths):
    rows = []
    for i, path in enumerate(paths):
        state = system.track_monocular(sc.image(), i / 30.0, image_path=path)
        rows.append((state.name, system.map.n_keyframes(), system.map.n_points()))
    return rows, dict(system.tracker.stats)


@pytest.fixture(scope="module")
def runs(scene):
    from anyfeature_vslam_tpu.ops.camera import CameraParams as JaxCamera
    from anyfeature_vslam_tpu.system import System as JaxSystem
    from anyfeature_vslam_tpu_torch.system import System

    sc, _, paths = scene
    jsys = JaxSystem(JaxCamera.create(**sc.camera), feature="r2d2_128", n_features=N_PTS,
                     async_mapping=False, use_mesh=False)
    tsys = System(dict_camera(sc), feature="r2d2_128", n_features=N_PTS, device="cpu",
                  async_mapping=False)
    assert tsys.map.desc_dim == jsys.map.desc_dim == 128
    assert np.dtype(tsys.map.desc_dtype) == np.float32
    assert tsys.map.n_feat == jsys.map.n_feat == N_PTS
    return _run(jsys, sc, paths), _run(tsys, sc, paths), tsys


def test_systems_initialize_alike(runs):
    (jrows, _), (trows, _), _ = runs
    ji = next(i for i, r in enumerate(jrows) if r[0] == "OK")
    ti = next(i for i, r in enumerate(trows) if r[0] == "OK")
    assert ti == ji
    assert abs(trows[ti][2] - jrows[ji][2]) <= 0.01 * jrows[ji][2] and jrows[ji][2] > 100


def test_systems_track_alike(runs):
    (jrows, jstats), (trows, tstats), tsys = runs
    for k in (1, 2):
        assert abs(trows[-1][k] - jrows[-1][k]) <= 0.25 * jrows[-1][k], (trows[-1], jrows[-1])
    assert tstats["lost_frames"] == jstats["lost_frames"] == 0
    assert tstats["resets"] == jstats["resets"] == 0
    assert tstats["tracked_frames"] == jstats["tracked_frames"] >= N_FRAMES - 3
    # precomputed frames take the staged path: no fused step was dispatched
    assert tsys.tracker._chain is None


def test_run_sequence_writes_the_keyframe_trajectory(scene, tmp_path):
    from anyfeature_vslam_tpu_torch.system import run_sequence

    _, root, _ = scene
    out = str(tmp_path / "out")
    system = run_sequence(root, feature="r2d2_128", out_dir=out, exp_id="r2d2", verbose=False,
                          n_features=N_PTS, device="cpu")
    assert system.tracker.precomputed and system.tracker.stats["lost_frames"] == 0
    assert system.map.n_keyframes() >= 2 and system.map.n_points() > 100
    lines = open(os.path.join(out, "r2d2_KeyFrameTrajectory.csv")).read().splitlines()
    assert lines[0].startswith("ts (ns)")
    rows = np.array([[float(v) for v in l.split(",")] for l in lines[1:]])
    assert rows.shape == (system.map.n_keyframes(), 8) and np.isfinite(rows).all()
    assert torch.device(system.device).type == "cpu"


def test_run_mono_takes_r2d2(scene, tmp_path, monkeypatch):
    """``run_mono feature:r2d2_128 device:cpu`` reaches the System, which
    reads each frame's features from the files beside its image."""
    from anyfeature_vslam_tpu_torch import run_mono
    from anyfeature_vslam_tpu_torch import system as tsystem

    built = []

    class Recording(tsystem.System):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(tsystem, "System", Recording)
    _, root, _ = scene
    out = str(tmp_path / "out")
    assert run_mono.main([f"sequence_path:{root}", f"exp_folder:{out}", "exp_id:t",
                          "feature:r2d2_128", f"n_features:{N_PTS}", "verbose:0",
                          "device:cpu"]) == 0
    (system,) = built
    assert system.tracker.precomputed and system.map.desc_dim == 128
    assert system.tracker.stats["tracked_frames"] >= N_FRAMES - 3
    assert os.path.exists(os.path.join(out, "t_KeyFrameTrajectory.csv"))
