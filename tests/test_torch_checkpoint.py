"""Map checkpoints: the port reads the JAX package's files and writes files
the JAX package reads. JAX save -> port load -> port save -> JAX load,
every array, the retired-keyframe anchors, the loop edges and the scalar
metadata exactly equal (the same .npz layout, no float arithmetic on the
way). And the port's System loads a checkpoint in place: the keyframes
enter its database, and its device caches start over."""

from types import SimpleNamespace

import numpy as np
import pytest

from anyfeature_vslam_tpu.slam.map_state import SlamMap as JaxMap
from anyfeature_vslam_tpu_torch.slam.map_state import SlamMap as PortMap
from anyfeature_vslam_tpu_torch.system import System
from loop_map import CAMERA, build_loop_map
from test_torch_constants import _scripted_maps


def _jax_maps():
    """A map that grew, merged, culled and retired keyframes, and the
    constructed loop map with a loop edge."""
    jm, _ = _scripted_maps()
    jm.loop_edges = [(1, 4), (0, 3)]
    lm, _ = build_loop_map(JaxMap)
    lm.loop_edges = [(25, 0)]
    return [jm, lm]


def _assert_same(a, b):
    arrays = sorted(k for k, v in vars(a).items() if isinstance(v, np.ndarray))
    assert arrays == sorted(k for k, v in vars(b).items() if isinstance(v, np.ndarray))
    for k in arrays:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    for k in ("max_kf", "max_pt", "n_feat", "desc_dim", "_next_kf", "_next_pt", "_uid_counter",
              "loop_edges", "uid_slot"):
        assert getattr(a, k) == getattr(b, k), k
    assert np.dtype(a.desc_dtype) == np.dtype(b.desc_dtype)
    assert sorted(a.retired_kfs) == sorted(b.retired_kfs)
    for u, (t, p) in a.retired_kfs.items():
        assert np.array_equal(b.retired_kfs[u][0], t) and b.retired_kfs[u][1] == p


@pytest.mark.parametrize("which", [0, 1])
def test_jax_port_jax_round_trip(tmp_path, which):
    jm = _jax_maps()[which]
    jm.save(str(tmp_path / "j.npz"))
    tm = PortMap.load(str(tmp_path / "j.npz"), device="cpu")
    _assert_same(jm, tm)
    assert tm.device == "cpu" and tm._mirror is None
    tm.save(str(tmp_path / "t.npz"))
    back = JaxMap.load(str(tmp_path / "t.npz"))
    _assert_same(jm, back)
    with np.load(str(tmp_path / "j.npz"), allow_pickle=False) as zj, \
            np.load(str(tmp_path / "t.npz"), allow_pickle=False) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert np.array_equal(zj[k], zt[k]), k


def test_system_loads_a_jax_checkpoint(tmp_path):
    lm = _jax_maps()[1]
    path = str(tmp_path / "loop.npz")
    lm.save(path)
    sys_ = System(SimpleNamespace(**CAMERA, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0),
                  n_features=200, device="cpu")
    sys_.local_mapper.kf_dev(0)  # a cached keyframe of the old map
    mirror_before = sys_.map.mirror()
    sys_.load_checkpoint(path)
    _assert_same(lm, sys_.map)
    assert sys_.local_mapper._dev_kf == {}
    assert sys_.map._mirror is None and sys_.map.mirror() is not mirror_before
    np.testing.assert_array_equal(sys_.map.mirror().gather(np.arange(5))[0].numpy(),
                                  lm.pt_pos[:5])
    assert sys_.database.present.sum() == lm.n_keyframes()
    assert sys_.map.on_kf_removed == sys_.database.erase
    kf = int(sys_.map.keyframe_ids()[3])
    sys_.map.remove_keyframe(kf)
    assert not sys_.database.present[kf]
    out = str(tmp_path / "again.npz")
    sys_.save_checkpoint(out)
    again = JaxMap.load(out)
    assert again.n_keyframes() == lm.n_keyframes() - 1 and again.loop_edges == [(25, 0)]
