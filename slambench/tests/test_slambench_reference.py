"""The plain reference against the port's extractors on the CPU, and the
control: the reference worked out in bfloat16, put in the program's
place, must be told apart. On the card (marked ``cuda``) the same with
the port's kernels at the cells' size."""

import pytest
import torch

from slambench import harness, scene
from slambench.check import frontend_bad

FAMILIES = ("orb32_tum1", "sift128_tum1")


def _frame(cam, device, seed=2 ** 31 + 3):
    spec = harness.load_json(harness.HERE / "traffic" / "explore.json")["scene"]
    plane = scene.ReliefPlane(spec, device)
    return scene.render_frames(plane, cam, scene.look_down_pose(3.0, 2.0, -2.0, 0.4)[None],
                               2.0, seed, chunk=1)


def _views(config, cam, device):
    from anyfeature_vslam_tpu_torch.frontend.extractor import ExtractorConfig, make_extractor

    feat = config["feature"]
    ec = ExtractorConfig.for_feature(feat["family"], feat["n_features"])
    frames = _frame(cam, device)
    ext = make_extractor(ec, cam["height"], cam["width"]).to(device)
    f = ext(frames[0].to(device).to(torch.float32))
    v = f["valid"]
    view = {k: f[src][v].cpu().numpy() for k, src in
            (("uv", "xy"), ("octave", "octave"), ("size", "size"), ("desc", "desc_bits"))}
    view["frame"] = 0
    return frames, [view]


def _limit(config_name):
    """frontend_bad_pct's limit in a cell of this configuration (its
    limits file; orb32's cell is out of BENCHMARK.json, its files stay)."""
    cell = next((harness.HERE / "limits").glob(f"{config_name}.*.json"))
    return harness.load_json(cell)["frontend_bad_pct"]


def _scaled(camera, scale):
    cam = dict(camera)
    for k in ("fx", "fy", "cx", "cy"):
        cam[k] *= scale
    cam["width"], cam["height"] = int(camera["width"] * scale), int(camera["height"] * scale)
    return cam


@pytest.mark.parametrize("name", FAMILIES)
def test_the_reference_equals_the_extractor_and_the_control_does_not(name):
    config = harness.load_config(harness.HERE / "configs" / f"{name}.json")
    cam = _scaled(config["camera"], 0.5)
    frames, views = _views(config, cam, "cpu")
    n, bad = frontend_bad(views, frames, config, "cpu")
    assert n > 200 and bad == 0
    n, bad = frontend_bad(views, frames, config, "cpu", control=True)
    assert 100.0 * bad / n > _limit(name)


def test_keypoints_the_extractor_left_out_are_counted():
    config = harness.load_config(harness.HERE / "configs" / "orb32_tum1.json")
    cam = _scaled(config["camera"], 0.5)
    frames, views = _views(config, cam, "cpu")
    n0 = len(views[0]["uv"])
    kept = [k for k in range(n0) if k % 10]
    thinned = [dict(views[0], **{k: views[0][k][kept] for k in ("uv", "octave", "size", "desc")})]
    n, bad = frontend_bad(thinned, frames, config, "cpu")
    # judged: the kept keypoints and the left-out ones; disputed: the left-out ones
    assert (n, bad) == (n0, n0 - len(kept))


@pytest.mark.cuda
@pytest.mark.parametrize("name", FAMILIES)
def test_on_the_card_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only there")
    config = harness.load_config(harness.HERE / "configs" / f"{name}.json")
    frames, views = _views(config, config["camera"], "cuda")
    n, bad = frontend_bad(views, frames, config, "cuda")
    assert n > 500 and bad == 0
    n, bad = frontend_bad(views, frames, config, "cuda", control=True)
    assert 100.0 * bad / n > _limit(name)
