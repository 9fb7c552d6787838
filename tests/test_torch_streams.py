"""The hand-offs and readiness probes of the asynchronous schedules
(anyfeature_vslam_tpu_torch/streams.py), and the asynchronous and threaded
Systems on the card.

On the CPU every hand-off is a no-op and every probe is ready at once. On
the card (tests marked cuda; ``python -m pytest --noconftest -m cuda
tests/test_torch_streams.py -q``): a probe's host copies equal the device
results exactly once it is set; a tensor produced on one stream and read
on another through a Handoff gives exactly the values a single stream
gives; the asynchronous System on the card against the CPU port with the
bounds of tests/test_torch_cuda.py's synchronous case (the same
initialization, counts within 10%, keyframe centres within 1e-2); the
threaded System on the card with the robustness bounds of
tests/test_torch_threaded_mapping.py (no reset, >= 20 of 24 frames
tracked, keyframe ATE < 5 cm, a clean shutdown).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from anyfeature_vslam_tpu_torch import streams
from anyfeature_vslam_tpu_torch.ops import cuda_match


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the port's runs at this size are launch-bound,
    and more threads only oversubscribe the cores other test workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card)")
    return torch.device("cuda", 0)


def test_ready_and_handoff_are_immediate_on_the_cpu():
    a, b = torch.arange(6).reshape(2, 3), torch.tensor(True)
    ready = streams.Ready((a, b))
    assert ready.is_set() and ready.event is None
    got = ready.host()
    assert np.array_equal(got[0], a.numpy()) and bool(got[1])
    h = streams.Handoff((a, b))
    assert h.event is None
    h.take()
    assert streams.new_stream("cpu") is None
    with streams.use(None):
        pass


@pytest.mark.cuda
def test_ready_lands_device_results_behind_an_event(cuda):
    side = streams.new_stream(cuda)
    x = torch.randn(2048, 2048, device=cuda)
    with streams.use(side):
        side.wait_stream(torch.cuda.current_stream(cuda))
        y = x
        for _ in range(20):
            y = torch.tanh(y @ x) * 0.01
        ready = streams.Ready((y, y.sum()))
    got = ready.host()
    assert ready.is_set()
    torch.cuda.synchronize()
    assert np.array_equal(got[0], y.cpu().numpy()) and got[1] == y.sum().cpu().numpy()


@pytest.mark.cuda
def test_handoff_orders_the_reading_stream(cuda):
    producer, reader = streams.new_stream(cuda), streams.new_stream(cuda)
    x = torch.randn(2048, 2048, device=cuda)
    want = x
    for _ in range(20):
        want = torch.tanh(want @ x) * 0.01
    want = want.sum(0).cpu()
    with streams.use(producer):
        producer.wait_stream(torch.cuda.current_stream(cuda))
        y = x
        for _ in range(20):
            y = torch.tanh(y @ x) * 0.01
        h = streams.Handoff((y,))
    with streams.use(reader):
        h.take()
        got = streams.Ready((y.sum(0),)).host()[0]
    del y, h
    assert np.array_equal(got, want.numpy())


def _scene_system(dev, n_frames, **kw):
    from anyfeature_vslam_tpu_torch.system import System
    from torch_slice_scene import SliceScene

    sc = SliceScene(320, 240, **kw.pop("scene", {}))
    frames = [sc.render(i)[0] for i in range(n_frames)]
    return sc, frames, System(SimpleNamespace(**sc.camera), n_features=600, device=dev, **kw)


@pytest.mark.cuda
def test_async_system_on_the_card_matches_the_cpu(cuda):
    runs = []
    for dev in (torch.device("cpu"), cuda):
        before = cuda_match.best_two.launches
        sc, frames, system = _scene_system(dev, 8)
        rows = []
        for i, img in enumerate(frames):
            system.local_mapper.wait_pending_ready()
            rows.append((system.track_monocular(img, i / 30.0).name, system.map.n_keyframes(),
                         system.map.n_points()))
        system.shutdown()
        m = system.map
        assert all(b["deferred"] for b in system.local_mapper.ba_log)
        centres = {int(m.kf_frame_id[k]): -m.kf_pose[k][:3, :3].T @ m.kf_pose[k][:3, 3]
                   for k in m.keyframe_ids()}
        runs.append((rows, centres, cuda_match.best_two.launches - before))
    (crows, ccentres, c_launch), (grows, gcentres, g_launch) = runs
    assert c_launch == 0 and g_launch > 0
    first_ok = [next(i for i, r in enumerate(rows) if r[0] == "OK") for rows in (crows, grows)]
    assert first_ok[0] == first_ok[1] and crows[first_ok[0]] == grows[first_ok[1]]
    for k in (1, 2):
        assert abs(grows[-1][k] - crows[-1][k]) <= 0.1 * crows[-1][k], (grows[-1], crows[-1])
    common = set(ccentres) & set(gcentres)
    assert len(common) >= 0.6 * len(ccentres)
    for fid in common:
        assert np.linalg.norm(gcentres[fid] - ccentres[fid]) < 1e-2, fid


@pytest.mark.cuda
def test_threaded_system_on_the_card(cuda):
    from anyfeature_vslam_tpu_torch.io import evaluation

    sc, frames, system = _scene_system(cuda, 24, scene=dict(n_frames=40, seed=9),
                                       threaded_mapping=True)
    for i, img in enumerate(frames):
        system.track_monocular(img, i / 30.0)
    system.shutdown(timeout=60.0)
    assert system._worker is None
    st = system.tracker.stats
    assert st["resets"] == 0 and st["tracked_frames"] >= 20, st
    m = system.map
    kfs = m.keyframe_ids()
    est = np.stack([-m.kf_pose[k][:3, :3].T @ m.kf_pose[k][:3, 3] for k in kfs])
    gt = np.stack([-sc.poses[f][:3, :3].T @ sc.poses[f][:3, 3] for f in m.kf_frame_id[kfs]])
    assert len(kfs) >= 3 and evaluation.ate_rmse(est, gt)[0] < 0.05
