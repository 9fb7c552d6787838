"""The port's host runtime (port of anyfeature_vslam_tpu/native.py): a frame
loader that decodes ahead of tracking on a reader thread, and ctypes
bindings of the host library ``csrc/slam_native.cpp`` (the PNG row
unfilter and the map-graph kernels), each beside its plain numpy twin.

``lib()`` builds the library with the host C++ compiler at first use
(``cuda_build.build_host``; ``_build/`` beside the package) and raises
``RuntimeError`` naming the compiler when it cannot: nothing falls back to
the twins, which the tests and chip_smoke.py hold the library against.

Kernels and twins (integer outputs equal exactly; float outputs equal bit
for bit, since the library is built with -ffp-contract=off and the twins
keep its order of operations):

- ``covisibility_weights``: (K,) points shared with one keyframe;
- ``point_obs_counts``: (max_pt,) observations per point;
- ``covisibility_matrix``: (K, K) shared observations of every pair;
- ``update_point_stats``: distinctive descriptor (first minimum median),
  mean viewing direction, scale band (maxKeyPtSize 3.58318), in place.
"""

from __future__ import annotations

import ctypes
import threading
import time

import numpy as np

from . import cuda_build

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_LIB = None
_LOCK = threading.Lock()
MAX_KEYPT_SIZE = np.float32(3.58318)  # 1.2^7, as the library


def lib() -> ctypes.CDLL:
    """The host library, built at first use; RuntimeError (naming the
    compiler) when it cannot be built."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lb = cuda_build.load_host("slam_native")
            lb.unfilter.restype = ctypes.c_int
            lb.unfilter.argtypes = [_P, _I64, _I64, _I64, _I64, _P, ctypes.POINTER(_I64)]
            lb.covisibility_weights.restype = None
            lb.covisibility_weights.argtypes = [_P, _P, _I64, _I64, _I64, _I64, _P, _P]
            lb.point_obs_counts.restype = None
            lb.point_obs_counts.argtypes = [_P, _P, _I64, _I64, _I64, _P]
            lb.covisibility_matrix.restype = None
            lb.covisibility_matrix.argtypes = [_P, _P, _I64, _I64, _I64, _P]
            lb.update_point_stats.restype = None
            lb.update_point_stats.argtypes = (
                [_P, _P, _P, ctypes.c_int, _P, _P, _I64, _I64, _I64, _I64, _P, _I64]
                + [_P] * 8)
            _LIB = lb
        return _LIB


def available() -> bool:
    """Whether the host library builds and loads here. The port never
    branches on it: where this is False, every caller of lib() raises."""
    try:
        lib()
    except RuntimeError:
        return False
    return True


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P)


# ----------------------------------------------------------------- imaging
def unfilter(raw, height: int, stride: int, bpp: int, path: str = "") -> np.ndarray:
    """The (height, stride) uint8 scanlines of a decompressed IDAT stream
    with each row's filter undone (the library's ``unfilter``); ValueError
    with `path` for data that is too short or an unknown filter type."""
    buf = np.frombuffer(raw, np.uint8)
    out = np.empty((height, stride), np.uint8)
    bad = _I64(-1)
    rc = lib().unfilter(_ptr(buf), buf.size, height, stride, bpp, _ptr(out), ctypes.byref(bad))
    if rc == -1:
        raise ValueError(f"{path}: image data too short")
    if rc == -2:
        row = bad.value
        raise ValueError(f"{path}: row {row} has filter type {int(buf[row * (stride + 1)])}")
    if rc != 0:
        raise ValueError(f"{path}: {bpp} bytes per pixel (1 to 8 are defined)")
    return out


# ------------------------------------------------------------- map kernels
def _graph_args(kf_matches, kf_valid):
    km = np.ascontiguousarray(kf_matches, np.int32)
    kv = np.ascontiguousarray(kf_valid, np.uint8)
    return km, kv, km.shape[0], km.shape[1]


def covisibility_weights(kf_matches, kf_valid, target: int, max_pt: int) -> np.ndarray:
    """(K,) int64 points shared by every valid keyframe with `target` (0
    for `target` itself and the invalid ones)."""
    km, kv, k, n = _graph_args(kf_matches, kf_valid)
    scratch = np.empty(max_pt, np.uint8)
    out = np.empty(k, np.int64)
    lib().covisibility_weights(_ptr(km), _ptr(kv), k, n, int(target), max_pt, _ptr(scratch),
                               _ptr(out))
    return out


def covisibility_weights_plain(kf_matches, kf_valid, target: int, max_pt: int) -> np.ndarray:
    mine = kf_matches[target]
    mask = np.zeros(max_pt, bool)
    mask[mine[(mine >= 0) & (mine < max_pt)]] = True
    rows = np.nonzero(kf_valid)[0]
    m = kf_matches[rows]
    w = np.zeros(kf_matches.shape[0], np.int64)
    w[rows] = ((m >= 0) & (m < max_pt) & mask[np.clip(m, 0, max_pt - 1)]).sum(1)
    w[target] = 0
    return w


def point_obs_counts(kf_matches, kf_valid, max_pt: int) -> np.ndarray:
    """(max_pt,) int64 observations of each point over the valid keyframes."""
    km, kv, k, n = _graph_args(kf_matches, kf_valid)
    out = np.empty(max_pt, np.int64)
    lib().point_obs_counts(_ptr(km), _ptr(kv), k, n, max_pt, _ptr(out))
    return out


def point_obs_counts_plain(kf_matches, kf_valid, max_pt: int) -> np.ndarray:
    m = kf_matches[np.nonzero(kf_valid)[0]]
    ids = m[(m >= 0) & (m < max_pt)]
    return np.bincount(ids, minlength=max_pt).astype(np.int64)


def covisibility_matrix(kf_matches, kf_valid, max_pt: int) -> np.ndarray:
    """(K, K) int32 shared-observation counts between valid keyframes: for
    each point, every pair of its observations adds one to both keyframes'
    entries (the diagonal counts a keyframe's own repeated observations)."""
    km, kv, k, n = _graph_args(kf_matches, kf_valid)
    out = np.empty((k, k), np.int32)
    lib().covisibility_matrix(_ptr(km), _ptr(kv), k, n, max_pt, _ptr(out))
    return out


def covisibility_matrix_plain(kf_matches, kf_valid, max_pt: int) -> np.ndarray:
    k = kf_matches.shape[0]
    out = np.zeros((k, k), np.int32)
    kfs = np.nonzero(kf_valid)[0]
    if len(kfs) == 0:
        return out
    m = kf_matches[kfs]
    ri, ci = np.nonzero((m >= 0) & (m < max_pt))
    if len(ri) == 0:
        return out
    pts, col = np.unique(m[ri, ci], return_inverse=True)
    counts = np.zeros((len(kfs), len(pts)), np.float64)
    np.add.at(counts, (ri, col), 1.0)
    w = counts @ counts.T
    w[np.diag_indices(len(kfs))] -= counts.sum(1)
    out[np.ix_(kfs, kfs)] = np.rint(w).astype(np.int32)
    return out


def update_point_stats(kf_matches, kf_valid, kf_desc, kf_size, kf_centers, pt_ids, pt_pos,
                       pt_ref_kf, pt_desc, pt_normal, pt_ref_size, pt_ref_dist, pt_min_dist,
                       pt_max_dist):
    """Distinctive descriptor, mean viewing direction and scale band of the
    points `pt_ids`, written in place into the pt_* arrays (which must be
    C-contiguous: pt_desc (max_pt, D) of kf_desc's dtype, pt_normal
    (max_pt, 3) float32, the rest (max_pt,) float32). kf_desc: (K, N, D)
    {0,1} uint8 bits (Hamming) or float32 (squared L2); kf_centers: (K, 3)
    float32 camera centres."""
    km, kv, k, n = _graph_args(kf_matches, kf_valid)
    d = kf_desc.shape[2]
    kd = np.ascontiguousarray(kf_desc)
    outs = (pt_desc, pt_normal, pt_ref_size, pt_ref_dist, pt_min_dist, pt_max_dist)
    for a, dtype in zip(outs, (kd.dtype,) + (np.float32,) * 5):
        if not a.flags["C_CONTIGUOUS"] or a.dtype != dtype:
            raise ValueError(f"update_point_stats writes in place: a C-contiguous {dtype} "
                             f"array is needed, not {a.dtype}")
    ks = np.ascontiguousarray(kf_size, np.float32)
    kc = np.ascontiguousarray(kf_centers, np.float32)
    ids = np.ascontiguousarray(pt_ids, np.int64)
    pp = np.ascontiguousarray(pt_pos, np.float32)
    pr = np.ascontiguousarray(pt_ref_kf, np.int32)
    lib().update_point_stats(
        _ptr(km), _ptr(kv), _ptr(kd), int(kd.dtype == np.uint8), _ptr(ks), _ptr(kc), k, n, d,
        pp.shape[0], _ptr(ids), len(ids), _ptr(pp), _ptr(pr), *(_ptr(a) for a in outs))


def _pairwise_distances(desc):
    """(n, O, D) descriptors -> (n, O, O) float32 distances in the
    library's order: Hamming (differing bytes) for uint8, squared L2
    summed over D in order for float32."""
    n, o, d = desc.shape
    if desc.dtype == np.uint8:
        out = np.empty((n, o, o), np.float32)
        for s in range(0, n, 256):
            blk = desc[s:s + 256]
            out[s:s + 256] = (blk[:, :, None, :] != blk[:, None, :, :]).sum(-1)
        return out
    acc = np.zeros((n, o, o), np.float32)
    for j in range(d):
        t = desc[:, :, None, j] - desc[:, None, :, j]
        acc += t * t
    return acc


def _norm3(v):
    return np.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])


def update_point_stats_plain(kf_matches, kf_valid, kf_desc, kf_size, kf_centers, pt_ids, pt_pos,
                             pt_ref_kf, pt_desc, pt_normal, pt_ref_size, pt_ref_dist,
                             pt_min_dist, pt_max_dist):
    max_pt = pt_pos.shape[0]
    pt_ids = np.unique(np.asarray(pt_ids, np.int64))
    pt_ids = pt_ids[(pt_ids >= 0) & (pt_ids < max_pt)]
    if len(pt_ids) == 0:
        return
    # observations of the selected points, grouped by point in
    # (keyframe, slot) order
    live = np.nonzero(kf_valid)[0]
    lut = np.full(max_pt, -1, np.int64)
    lut[pt_ids] = np.arange(len(pt_ids))
    m = kf_matches[live]
    ki, oslot = np.nonzero((m >= 0) & (m < max_pt) & (lut[np.clip(m, 0, max_pt - 1)] >= 0))
    okf = live[ki]
    opl = lut[m[ki, oslot]]
    order = np.argsort(opl, kind="stable")
    okf, oslot, opl = okf[order], oslot[order], opl[order]
    n_p = len(pt_ids)
    counts = np.bincount(opl, minlength=n_p)
    starts = np.cumsum(counts) - counts
    rank = np.arange(len(opl)) - starts[opl]

    # distinctive descriptor: the observation with the smallest median
    # distance to the others (sorted row element (O-1)/2, first minimum)
    best = np.zeros(n_p, np.int64)
    for o in np.unique(counts[counts > 1]):
        sel = np.nonzero(counts == o)[0]
        idx = starts[sel][:, None] + np.arange(o)
        d = _pairwise_distances(kf_desc[okf[idx], oslot[idx]])
        med = np.sort(d, axis=-1)[:, :, (o - 1) // 2]
        best[sel] = np.argmin(med, axis=1)
    has = np.nonzero(counts > 0)[0]
    pts = pt_ids[has]
    src = starts[has] + best[has]
    pt_desc[pts] = kf_desc[okf[src], oslot[src]]

    # mean viewing direction: unit vectors summed in float32, observation
    # by observation (each rank holds a point at most once)
    v = pt_pos[pt_ids[opl]] - kf_centers[okf]
    unit = v / np.maximum(_norm3(v), np.float32(1e-9))[:, None]
    sums = np.zeros((n_p, 3), np.float32)
    for r in range(int(counts.max()) if len(opl) else 0):
        at = rank == r
        sums[opl[at]] += unit[at]
    inv = (np.float32(1.0) / counts[has].astype(np.float32))[:, None]
    pt_normal[pts] = sums[has] * inv

    # scale band from the reference keyframe's observation, else the first
    is_ref = okf == pt_ref_kf[pt_ids[opl]]
    big = np.iinfo(np.int64).max
    ref_rank = np.full(n_p, big, np.int64)
    np.minimum.at(ref_rank, opl[is_ref], rank[is_ref])
    ref_rank = np.where(ref_rank == big, 0, ref_rank)
    ro = starts[has] + ref_rank[has]
    dist = _norm3(pt_pos[pts] - kf_centers[okf[ro]])
    size = kf_size[okf[ro], oslot[ro]]
    pt_ref_size[pts] = size
    pt_ref_dist[pts] = dist
    pt_max_dist[pts] = np.float32(1.2) * dist * size
    pt_min_dist[pts] = np.float32(0.8) * dist * size / MAX_KEYPT_SIZE


# ------------------------------------------------------------------ loader
class FrameLoader:
    """Frames read ahead of tracking on a reader thread (the JAX package's
    native.FrameLoader): the thread decodes paths[i] with the port's
    ``io.dataset.load_gray``, so every frame equals load_gray's (float32,
    (height, width)) by construction, and keeps at most ``ahead + 1``
    decoded frames. Its heavy steps release the GIL (zlib's inflate, the
    library's unfilter), so decoding overlaps the tracking thread.

    ``get(i)`` returns frame i, waiting for it if needed; frames are asked
    for in increasing order, and asking past the window drops the frames
    below i (the reader skips ahead, never deadlocks). A frame that cannot
    be read, or whose size is not (height, width), raises RuntimeError in
    its ``get(i)``, naming its path; nothing falls back to decoding on the
    caller's thread. ``close()`` (or leaving a ``with`` block) stops the
    reader. ``decode_s`` (frame -> seconds on the reader thread) and
    ``wait_s`` (seconds each ``get`` waited) are kept for measurement.

    Unlike the JAX package's C++ decode (libpng), which keeps the high
    byte of 16-bit gray and converts RGB in C compiled with
    -march=native, the frames here follow load_gray, which matches PIL:
    16-bit gray clipped to 255, float32 0.299 R + 0.587 G + 0.114 B."""

    def __init__(self, paths, height: int, width: int, ahead: int = 4):
        from .io import dataset

        self.paths = list(paths)
        self.height, self.width, self.ahead = int(height), int(width), int(ahead)
        self.decode_s: dict = {}
        self.wait_s: list = []
        self._load = dataset.load_gray
        self._cv = threading.Condition()
        self._ready: dict = {}   # frame -> (image, exception)
        self._want = 0           # the lowest frame still needed
        self._next = 0           # the frame the reader decodes next
        self._stop = False
        self._done = False
        self._thread = threading.Thread(target=self._run, name="frame-loader", daemon=True)
        self._thread.start()

    def _decode(self, i):
        path = self.paths[i]
        try:
            img = self._load(path)
        except Exception as e:  # noqa: BLE001 - raised again in get(i)
            return None, e
        if img.shape != (self.height, self.width):
            return None, ValueError(f"the frame is {img.shape[1]}x{img.shape[0]}, the "
                                    f"sequence's camera {self.width}x{self.height}")
        return img, None

    def _run(self):
        try:
            while True:
                with self._cv:
                    self._cv.wait_for(lambda: self._stop or (
                        self._next < len(self.paths) and len(self._ready) <= self.ahead))
                    if self._stop:
                        return
                    i = self._next = max(self._next, self._want)
                    if i >= len(self.paths):
                        return
                t0 = time.perf_counter()
                item = self._decode(i)
                dt = time.perf_counter() - t0
                with self._cv:
                    self._ready[i] = item
                    self.decode_s[i] = dt
                    self._next = i + 1
                    self._cv.notify_all()
        finally:
            with self._cv:
                self._done = True
                self._cv.notify_all()

    def get(self, i: int) -> np.ndarray:
        if not 0 <= i < len(self.paths):
            raise IndexError(f"frame {i} of {len(self.paths)}")
        t0 = time.perf_counter()
        with self._cv:
            if self._stop:
                raise RuntimeError("the frame loader is closed")
            if i not in self._ready and i < self._next:
                raise RuntimeError(f"frame {i} was read already ({self.paths[i]}): frames "
                                   "are asked for in increasing order")
            self._want = i
            # drop stale frames now, so a full window cannot stall the
            # reader when the caller skips ahead
            for j in [j for j in self._ready if j < i]:
                del self._ready[j]
            self._cv.notify_all()
            self._cv.wait_for(lambda: self._stop or self._done or i in self._ready)
            if i not in self._ready:
                raise RuntimeError(f"the frame loader stopped before frame {i} "
                                   f"({self.paths[i]})")
            img, err = self._ready.pop(i)
            self._cv.notify_all()
        self.wait_s.append(time.perf_counter() - t0)
        if err is not None:
            raise RuntimeError(f"frame {i} ({self.paths[i]}) could not be read: {err}") from err
        return img

    def close(self):
        with self._cv:
            self._stop = True
            self._ready.clear()
            self._cv.notify_all()
        if self._thread.is_alive() and self._thread is not threading.current_thread():
            self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass
