"""The offline viewer of the PyTorch port (io/viewer.py) against the JAX
package's: the map SVG, the frame overlay and its PNG, and the System's
render_frame and save_outputs.

Tolerances: none. The SVG text, the overlay array and the PNG's pixels
and ``slam_state`` text equal JAX's exactly (the same host numpy on the
same map; the port writes the PNG with zlib and struct, JAX with PIL, and
PIL decodes both here).
"""

import os
import xml.etree.ElementTree as ET
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from anyfeature_vslam_tpu.io import viewer as jviewer
from anyfeature_vslam_tpu.slam.map_state import SlamMap as JaxMap
from anyfeature_vslam_tpu_torch.io import viewer as tviewer
from anyfeature_vslam_tpu_torch.slam.map_state import SlamMap as TorchMap
from anyfeature_vslam_tpu_torch.system import System
from torch_slice_scene import SliceScene


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _build(m, seed=0):
    """tests/test_checkpoint_viewer.py's small map, with a third keyframe
    that is culled (its frames resolve through the retired chain) and a
    dropped point."""
    rng = np.random.default_rng(seed)
    feats = dict(uv_und=rng.uniform(0, 640, (64, 2)).astype(np.float32),
                 desc_bits=rng.normal(size=(64, 128)).astype(np.float32),
                 octave=np.zeros(64, np.int32), size=np.ones(64, np.float32),
                 angle=np.zeros(64, np.float32), inv_sigma2=np.ones(64, np.float32),
                 valid=np.ones(64, bool))
    ids = m.add_points(rng.normal(size=(40, 3)).astype(np.float32) + [0, 0, 5],
                       rng.normal(size=(40, 128)).astype(np.float32), ref_kf=0,
                       ref_sizes=np.ones(40, np.float32))
    m.pt_valid[ids[7]] = False
    matches = np.full(64, -1, np.int32)
    matches[:40] = ids
    kfs = []
    for i, x in enumerate((0.0, 0.5, 1.25)):
        t = np.eye(4, dtype=np.float32)
        t[0, 3] = -x
        t[2, 3] = 0.1 * i
        kfs.append(m.add_keyframe(t, i / 30, i, feats, matches.copy()))
    traj = []
    for i in range(9):
        t_cr = np.eye(4, dtype=np.float32)
        t_cr[:3, 3] = rng.normal(0, 0.05, 3)
        traj.append((i / 30, t_cr, int(m.kf_uid[kfs[i % 3]]), i == 4))
    m.remove_keyframe(kfs[2])
    return m, traj


def maps():
    jm, jtraj = _build(JaxMap(max_kf=8, max_pt=200, n_feat=64, desc_dim=128,
                              desc_dtype=np.float32))
    tm, ttraj = _build(TorchMap(max_kf=8, max_pt=200, n_feat=64, desc_dim=128,
                                desc_dtype=np.float32, device="cpu"))
    return (jm, jtraj), (tm, ttraj)


def test_map_svg_equals_jax(tmp_path):
    (jm, jtraj), (tm, ttraj) = maps()
    jc = jviewer.trajectory_centers(jtraj, jm)
    tc = tviewer.trajectory_centers(ttraj, tm)
    assert len(tc) == 8
    np.testing.assert_array_equal(tc, jc)
    for axes in ((0, 2), (0, 1)):
        jp = jviewer.render_map_svg(jm, str(tmp_path / "j.svg"), trajectory=jc, axes=axes)
        tp = tviewer.render_map_svg(tm, str(tmp_path / "t.svg"), trajectory=tc, axes=axes)
        text = open(tp).read()
        assert text == open(jp).read()
        root = ET.fromstring(text)
        tags = [el.tag.split("}")[1] for el in root]
        assert tags.count("circle") == 39 and tags.count("path") == 1
        assert tags.count("rect") == 1 + 2  # the background and the live keyframes
    # an empty map and no trajectory
    empty_j = jviewer.render_map_svg(JaxMap(max_kf=2, max_pt=4, n_feat=4),
                                     str(tmp_path / "je.svg"))
    empty_t = tviewer.render_map_svg(TorchMap(max_kf=2, max_pt=4, n_feat=4, device="cpu"),
                                     str(tmp_path / "te.svg"))
    assert open(empty_t).read() == open(empty_j).read()


def _overlay_inputs(seed=3):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-20, 280, (120, 160)).astype(np.float32)
    xy = np.concatenate([np.array([[20.0, 30.0], [100.0, 60.0], [150.0, 110.0], [0.4, 0.4],
                                   [159.6, 119.4], [-3.0, 50.0]], np.float32),
                         rng.uniform(-5, 165, (60, 2)).astype(np.float32)])
    valid = rng.random(len(xy)) < 0.8
    valid[:3] = (True, True, False)
    matches = np.where(rng.random(len(xy)) < 0.5, 7, -1).astype(np.int32)
    matches[:3] = (5, -1, -1)
    return img, dict(xy=xy, valid=valid), matches


def test_frame_overlay_and_png_equal_jax(tmp_path):
    img, feats, matches = _overlay_inputs()
    jp, tp = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    jout = jviewer.render_frame_overlay(img, feats, matches, state_text="OK", path=jp)
    tout = tviewer.render_frame_overlay(img, feats, matches, state_text="OK", path=tp)
    assert tout.dtype == np.uint8 and tout.shape == (120, 160, 3)
    np.testing.assert_array_equal(tout, jout)
    assert (tout[27, 17] == (90, 230, 90)).all() and (tout[57, 97] == (110, 160, 255)).all()
    with Image.open(tp) as ti, Image.open(jp) as ji:
        assert ti.mode == ji.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(ti), np.asarray(ji))
        np.testing.assert_array_equal(np.asarray(ti), tout)
        assert ti.text == ji.text == {"slam_state": "OK"}
    # no state text: no text chunk; no matches: every box blue
    out = tviewer.render_frame_overlay(img, feats, None, path=tp)
    np.testing.assert_array_equal(out, jviewer.render_frame_overlay(img, feats, None))
    with Image.open(tp) as ti:
        assert not ti.text
        np.testing.assert_array_equal(np.asarray(ti), out)


def test_system_render_frame_and_map_svg(tmp_path):
    """The System's render_frame (None before any frame; the last retired
    frame's features, matches and state after) and save_outputs' map SVG,
    against JAX's viewer on the same inputs."""
    sc = SliceScene(320, 240)
    system = System(SimpleNamespace(**sc.camera), n_features=600, async_mapping=False,
                    device="cpu")
    img = sc.render(0)[0]
    assert system.render_frame(img) is None
    for i in range(4):
        img = sc.render(i)[0]
        system.track_monocular(img, i / 30.0)
    assert system.tracker.state.name == "OK" and system.map.n_points() > 100
    path = str(tmp_path / "frame.png")
    out = system.render_frame(img, path=path)
    f = system.tracker.last
    want = jviewer.render_frame_overlay(img, {k: f.feats[k] for k in ("xy", "valid")},
                                        f.matches, state_text=system.tracker.state.name)
    np.testing.assert_array_equal(out, want)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), out)
        assert im.text["slam_state"] == system.tracker.state.name
    system.save_outputs(str(tmp_path / "out"), "e")
    svg = os.path.join(str(tmp_path / "out"), "e_map.svg")
    root = ET.parse(svg).getroot()
    f = system.tracker.last
    tracked = int(((f.matches >= 0) & f.feats["valid"]).sum())
    assert 50 < tracked < int(f.feats["valid"].sum())  # green and blue boxes both drawn
    assert sum(el.tag.endswith("circle") for el in root) == system.map.n_points()
    assert sum(el.tag.endswith("rect") for el in root) == 1 + system.map.n_keyframes()
