"""One rank of the port's System with use_mesh="auto" over a gloo group.

    python tests/torch_mesh_system_worker.py <rank> <world> <store file> \
        <first frame> <n frames> <out.npz>

The ranks meet through a file store (no network; a 60 s timeout). Each
renders tests/torch_slice_scene.py's SliceScene at 320x240, tracks frames
first .. first + n - 1 with a synchronous orb32 System on the CPU (600
features, no loop closing) whose local BAs are sharded over the group,
and writes the per-frame state names and map counts, the keyframe poses
by frame id, the tracker's counters and the local BAs' mesh sizes to
<out.npz>. Ranks given different first frames must fail: their first
sharded solve finds that the problems differ. Imports torch and the port,
never jax.
"""

import os
import sys
from datetime import timedelta
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from anyfeature_vslam_tpu_torch.system import System  # noqa: E402
from torch_slice_scene import SliceScene  # noqa: E402


def main(argv):
    rank, world, store, first, n, out_path = argv
    rank, world, first, n = int(rank), int(world), int(first), int(n)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        sc = SliceScene(320, 240)
        system = System(SimpleNamespace(**sc.camera), device="cpu", feature="orb32",
                        n_features=600, enable_loop_closing=False, async_mapping=False,
                        use_mesh="auto")
        assert system.mesh is not None and (system.mesh.size, system.mesh.rank) == (world, rank)
        names, counts = [], []
        for i in range(first, first + n):
            state = system.track_monocular(sc.render(i)[0], i / 30.0)
            names.append(state.name)
            counts.append((system.map.n_keyframes(), system.map.n_points()))
        m = system.map
        kf_ids = [int(k) for k in m.keyframe_ids()]
        stats = system.tracker.stats
        np.savez(out_path, names=np.array(names), counts=np.array(counts),
                 kf_frame=np.array([int(m.kf_frame_id[k]) for k in kf_ids]),
                 kf_pose=np.stack([m.kf_pose[k] for k in kf_ids]),
                 resets=stats["resets"], lost=stats["lost_frames"],
                 ba_mesh=np.array([b.get("mesh", 0) for b in system.local_mapper.ba_log]),
                 ba_dense=np.array([b["dense"] for b in system.local_mapper.ba_log]))
        system.shutdown()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
