"""Device-resident mirror of the map's point structure-of-arrays (port of
anyfeature_vslam_tpu/slam/device_map.py).

Geometry consumers (the tracker's local-map block, mapping fusion) need
the point SoA on the device while the map is mutated on the host. The
mirror keeps every point row on the device and keeps it fresh with
dirty-row uploads: each host mutation marks its point ids in
``SlamMap.pt_dirty``; ``sync`` copies just those rows into the device
tensors. Consumers pass id arrays and gather on the device (``gather``).
The JAX package pads the dirty ids to a bucket and drops the padding in a
donated scatter program; eager PyTorch writes the rows in place with no
padding.
"""

from __future__ import annotations

import numpy as np
import torch

# (field name on SlamMap) in the order gather returns them, pt_valid last
FIELDS = ("pt_pos", "pt_normal", "pt_min_dist", "pt_max_dist", "pt_ref_size",
          "pt_ref_dist", "pt_desc_bits", "pt_valid")


class DevicePointMirror:
    def __init__(self, slam_map, device):
        self.map = slam_map
        self.device = torch.device(device)
        self._arrs = None
        self._cap = 0

    def _upload(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _full_upload(self):
        m = self.map
        # clear before reading: a mutation after the read re-marks its rows
        m.pt_dirty[:] = False
        self._arrs = tuple(self._upload(getattr(m, name)) for name in FIELDS)
        self._cap = m.max_pt

    def sync(self):
        """Bring the mirror up to date with the host map; returns the
        device tensors in FIELDS order."""
        m = self.map
        if self._arrs is None or self._cap != m.max_pt:
            self._full_upload()
            return self._arrs
        ids = np.nonzero(m.pt_dirty)[0]
        if len(ids) == 0:
            return self._arrs
        m.pt_dirty[ids] = False
        ids_d = self._upload(ids)
        for arr, name in zip(self._arrs, FIELDS):
            arr[ids_d] = self._upload(getattr(m, name)[ids])
        return self._arrs

    def gather(self, ids):
        """Sync, then gather rows on the device: (pos, normal, min_d,
        max_d, ref_size, ref_dist, desc_bits, valid) for `ids` (numpy or
        tensor, any shape; -1 entries come back invalid)."""
        arrs = self.sync()
        if not isinstance(ids, torch.Tensor):
            ids = self._upload(np.asarray(ids, np.int64))
        ids = ids.to(device=self.device, dtype=torch.int64)
        safe = torch.clamp(ids, min=0)
        out = [a[safe] for a in arrs]
        out[-1] = out[-1] & (ids >= 0)
        return tuple(out)
