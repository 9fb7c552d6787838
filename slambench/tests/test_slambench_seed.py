"""The seed draws only the sensor noise: the scene, the path and the frame
count come from the traffic file."""

import numpy as np
import pytest
import torch

from slambench import harness, scene

SMALL = dict(fx=517.306408 / 8, fy=516.469215 / 8, cx=318.643040 / 8, cy=255.313989 / 8,
             width=80, height=60)


def _frames(traffic, seed, sigma=None, n=6):
    plane = scene.ReliefPlane(traffic["scene"], "cpu")
    poses = scene.camera_path(traffic["path"], n, 30.0)
    noise = traffic["noise_sigma"] if sigma is None else sigma
    return poses, scene.render_frames(plane, SMALL, poses, noise, seed, chunk=4)


@pytest.mark.parametrize("traffic", ["explore", "revisit"])
def test_two_seeds_share_the_noise_free_frames_and_the_path(traffic):
    spec = harness.load_json(harness.HERE / "traffic" / f"{traffic}.json")
    p1, f1 = _frames(spec, 1, sigma=0.0)
    p2, f2 = _frames(spec, 2 ** 31 + 5, sigma=0.0)
    assert np.array_equal(p1, p2)
    assert torch.equal(f1, f2)


@pytest.mark.parametrize("traffic", ["explore", "revisit"])
def test_one_seed_gives_identical_frames_and_another_only_other_noise(traffic):
    spec = harness.load_json(harness.HERE / "traffic" / f"{traffic}.json")
    _, a = _frames(spec, 2 ** 31 + 11)
    _, b = _frames(spec, 2 ** 31 + 11)
    _, c = _frames(spec, 2 ** 31 + 12)
    _, clean = _frames(spec, 0, sigma=0.0)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    for noisy in (a, c):
        d = noisy.to(torch.float32) - clean.to(torch.float32)
        # zero-mean read noise of sigma gray levels, cut to uint8 (a floor)
        assert abs(float(d.mean()) + 0.5) < 0.2
        assert 0.5 * spec["noise_sigma"] < float(d.std()) < 1.5 * spec["noise_sigma"]


def test_frame_count_and_path_come_from_the_traffic_file():
    spec = harness.load_json(harness.HERE / "traffic" / "explore.json")
    poses = scene.camera_path(spec["path"], int(spec["frames"]), 30.0)
    assert len(poses) == spec["frames"]
    c = -np.einsum("nji,nj->ni", poses[:, :3, :3], poses[:, :3, 3])
    step = np.linalg.norm(np.diff(c, axis=0), axis=1)
    assert np.allclose(step[step > 0.9 * step.max()], spec["path"]["speed_m_s"] / 30.0, rtol=1e-6)
    with pytest.raises(ValueError, match="path ends"):
        scene.camera_path(spec["path"], 10 * int(spec["frames"]), 30.0)


def test_the_scene_is_the_repositorys_relief_plane():
    import sys

    sys.path.insert(0, str(harness.ROOT / "tests"))
    from synth_scene import PlaneScene, make_texture

    spec = harness.load_json(harness.HERE / "traffic" / "explore.json")["scene"]
    plane = scene.ReliefPlane(spec, "cpu")
    tex = make_texture(n_blobs=spec["blobs"], seed=spec["seed"])
    assert np.array_equal(plane.tex.numpy(), tex)
    k = np.array([[SMALL["fx"], 0, SMALL["cx"]], [0, SMALL["fy"], SMALL["cy"]], [0, 0, 1]])
    ref = PlaneScene(k, SMALL["width"], SMALL["height"], seed=spec["seed"], tex=tex)
    pose = scene.look_down_pose(2.6, 2.4, -2.0, 0.2)
    img, depth = plane.render(SMALL, pose[None])
    want_img, want_depth = ref.render_with_depth(pose)
    assert np.array_equal(img[0].numpy(), want_img)
    assert np.array_equal(depth[0].numpy(), want_depth)
