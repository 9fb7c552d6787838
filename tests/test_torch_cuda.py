"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card. Skipped without a CUDA device. This file imports no JAX, so it runs
on the card's machine, which has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

K1 and binary K2 must be exact. Float K2 on unit rows (as the learned48
descriptors are) must be within FLOAT_ATOL = 1e-5 of its twin, best and
second, with the index equal wherever best and second lie further apart:
the kernel sums q.c in fp32 in another order. Float searches run with
their random windows and with none (radius INF, every valid pair passes,
as the reference-keyframe search).
"""

import numpy as np
import pytest
import torch

from anyfeature_vslam_tpu_torch.frontend import cuda_fast
from anyfeature_vslam_tpu_torch.ops import cuda_match

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("hw", [(5, 5), (7, 40), (33, 65), (134, 179), (480, 640), (1080, 1920)])
@pytest.mark.parametrize("kind", ["uniform", "levels"])
def test_fast_nms_kernel_is_bit_exact(cuda, hw, kind):
    rng = np.random.default_rng(hw[0] * 7 + hw[1])
    if kind == "uniform":
        img = rng.uniform(0, 255, hw).astype(np.float32)
    else:
        img = (rng.integers(0, 6, hw) * 40.0).astype(np.float32)
    x = torch.from_numpy(img).to(cuda)
    before = cuda_fast.fast_nms.launches
    got = cuda_fast.fast_nms(x, 20.0)
    want = cuda_fast.fast_nms_plain(x, 20.0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert cuda_fast.fast_nms.launches == before + 1


def _levels_of(img):
    from anyfeature_vslam_tpu_torch.frontend import pyramid
    from anyfeature_vslam_tpu_torch.frontend.extractor import ExtractorConfig, OrbExtractor

    h, w = img.shape
    ext = OrbExtractor(ExtractorConfig(n_features=1000), h, w).to(img.device)
    return [l.contiguous() for l in pyramid.build_pyramid(img, ext.resize_mats())]


def _assert_levels_exact(levels):
    before = cuda_fast.fast_nms.launches
    got = cuda_fast.fast_nms_levels(levels, 20.0)
    assert cuda_fast.fast_nms.launches == before + 1
    for lev, score in zip(levels, got):
        want = cuda_fast.fast_nms_plain(lev, 20.0)
        torch.cuda.synchronize()
        assert score.shape == lev.shape and torch.equal(score, want), tuple(lev.shape)


def test_fast_nms_levels_one_launch_on_a_rendered_frame(cuda):
    from torch_slice_scene import FIRST_TRACKED, SliceScene

    img8 = SliceScene(640, 480).render(FIRST_TRACKED)[0]
    levels = _levels_of(torch.from_numpy(img8).to(cuda).float())
    assert [tuple(l.shape) for l in levels][::7] == [(480, 640), (134, 179)]
    _assert_levels_exact(levels)


@pytest.mark.parametrize("shapes", [
    [(5, 5), (7, 40), (33, 65), (134, 179)],
    [(1, 1), (61, 33), (2, 300), (97, 97), (31, 31), (32, 32), (3, 3), (7, 7)],
    [(480, 640)],
])
@pytest.mark.parametrize("kind", ["uniform", "levels"])
def test_fast_nms_levels_odd_tables(cuda, shapes, kind):
    rng = np.random.default_rng(len(shapes))
    levels = []
    for hw in shapes:
        img = (rng.uniform(0, 255, hw) if kind == "uniform"
               else rng.integers(0, 6, hw) * 40.0).astype(np.float32)
        levels.append(torch.from_numpy(img).to(cuda))
    _assert_levels_exact(levels)


def test_fast_nms_kernel_rejects_bad_input(cuda):
    with pytest.raises(ValueError):
        cuda_fast.fast_nms(torch.zeros((32, 32), dtype=torch.float64, device=cuda), 20.0)
    with pytest.raises(ValueError):
        cuda_fast.fast_nms(torch.zeros((32, 64), device=cuda).T, 20.0)


def _case(dev, nq, nc, dim, binary, seed=0):
    rng = np.random.default_rng(seed)
    if binary:
        q = rng.integers(0, 2, (nq, dim)).astype(np.uint8)
        c = rng.integers(0, 2, (nc, dim)).astype(np.uint8)
        c[nc // 2:] = c[:nc - nc // 2]  # duplicated rows: exact ties
    else:
        q = rng.normal(size=(nq, dim)).astype(np.float32)
        c = rng.normal(size=(nc, dim)).astype(np.float32)
    side = (
        rng.uniform(0, 640, (nq, 2)), rng.uniform(0, 640, (nc, 2)),
        np.where(rng.random(nq) < 0.9, rng.uniform(20, 300, nq), -1.0),
        rng.uniform(0.5, 1.2, nq), rng.uniform(2.0, 4.0, nq), rng.uniform(1, 3.6, nc),
    )
    side = [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in side]
    valid = torch.from_numpy(rng.random(nc) < 0.9).to(dev)
    q_uv, c_uv, q_rad, q_slo, q_shi, c_size = side
    return (torch.from_numpy(q).to(dev), torch.from_numpy(c).to(dev),
            q_uv, c_uv, q_rad, q_slo, q_shi, c_size, valid)


@pytest.mark.parametrize("dim", [256, 384, 488, 512])
@pytest.mark.parametrize("nq,nc", [(1, 1), (7, 300), (300, 257), (4096, 1000)])
def test_best_two_binary_kernel_is_exact(cuda, dim, nq, nc):
    args = _case(cuda, nq, nc, dim, True)
    before = cuda_match.best_two.launches
    b, i, s = cuda_match.best_two(*args)
    rb, ri, rs = cuda_match.reference_best_two(*args)
    torch.cuda.synchronize()
    assert torch.equal(b, rb) and torch.equal(i.long(), ri) and torch.equal(s, rs)
    assert cuda_match.best_two.launches == before + 1


FLOAT_ATOL = 1e-5


def _float_case(dev, nq, nc, dim, seed=0, window=True):
    """_case with unit rows; every other candidate row duplicates an
    earlier one (exact ties). window=False: no window (radius INF, no
    size band)."""
    args = list(_case(dev, nq, nc, dim, False, seed))
    for k in (0, 1):
        args[k] = args[k] / torch.linalg.norm(args[k], dim=1, keepdim=True)
    half = nc // 2
    for k in (1, 3, 7, 8):
        args[k][half:2 * half] = args[k][:half]
    if not window:
        args[4] = torch.full_like(args[4], cuda_match.INF)
        args[5] = torch.zeros_like(args[5])
        args[6] = torch.full_like(args[6], cuda_match.INF)
    return args


def _assert_float_close(got, want):
    (b, i, s), (rb, ri, rs) = got, want
    torch.cuda.synchronize()
    assert float((b - rb).abs().max()) <= FLOAT_ATOL
    assert float((s - rs).abs().max()) <= FLOAT_ATOL
    clear = (rs - rb) > FLOAT_ATOL
    assert torch.equal(i.long()[clear], ri[clear])


def _assert_float_search(args):
    """One launch on the prepared set, within FLOAT_ATOL of the twin, and
    the same result from raw rows (which the search prepares itself)."""
    fs = cuda_match.pack_candidates(args[1])
    before = cuda_match.best_two.launches
    got = cuda_match.best_two(args[0], fs, *args[2:])
    assert cuda_match.best_two.launches == before + 1
    _assert_float_close(got, cuda_match.reference_best_two(*args))
    raw = cuda_match.best_two(*args)
    for x, y in zip(got, raw):
        assert torch.equal(x, y)
    return got


@pytest.mark.parametrize("window", [True, False])
@pytest.mark.parametrize("dim", [48, 64, 128])
@pytest.mark.parametrize("nq,nc", [(1, 1), (7, 300), (300, 257), (1000, 1000), (2000, 2000),
                                   (4096, 1000)])
def test_best_two_float_kernel_matches(cuda, dim, nq, nc, window):
    _assert_float_search(_float_case(cuda, nq, nc, dim, window=window))


@pytest.mark.parametrize("window", [True, False])
@pytest.mark.parametrize("dim", [48, 128])
def test_best_two_float_tiled_candidates(cuda, dim, window):
    # more candidates than the search stages whole (double-buffered gate
    # tiles of 1024)
    _assert_float_search(_float_case(cuda, 700, 5000, dim, seed=1, window=window))


@pytest.mark.parametrize("window", [True, False])
@pytest.mark.parametrize("nq", [1, 16, 17, 528, 529, 1056, 1057, 2112, 2113, 4096, 8200])
def test_best_two_float_queries_per_block_boundaries(cuda, nq, window):
    # a query's candidates over 8, 4, 2, 1 warps up to 528, 1056, 2112
    # queries and above (csrc/best_two.cu, launch_f32_split)
    _assert_float_search(_float_case(cuda, nq, 1000, 64, seed=2, window=window))


@pytest.mark.parametrize("dim", [48, 64, 128])
def test_best_two_float_duplicates_at_radius_inf(cuda, dim):
    args = _float_case(cuda, 2048, 3000, dim, seed=3, window=False)
    b, i, s = _assert_float_search(args)
    ok = i >= 0
    assert bool(ok.all()) and bool((i < 1500).all()) and bool((s == b).all())


@pytest.mark.parametrize("window", [True, False])
def test_best_two_float_no_candidates_and_bad_input(cuda, window):
    args = _float_case(cuda, 64, 100, 48, window=window)
    args[8] = torch.zeros_like(args[8])
    b, i, s = _assert_float_search(args)
    assert bool((i == -1).all()) and bool((b == cuda_match.INF).all())
    assert bool((s == cuda_match.INF).all())
    fs = cuda_match.pack_candidates(args[1])
    with pytest.raises(ValueError):  # norms of another set
        cuda_match.best_two(args[0], cuda_match.FloatSet(fs.rows, fs.norms[:-1]), *args[2:])
    with pytest.raises(ValueError):  # rows of another width
        cuda_match.best_two(args[0][:, :32].contiguous(), fs, *args[2:])
    before = cuda_match.best_two.launches
    empty = cuda_match.best_two(args[0], cuda_match.pack_candidates(args[1][:0]),
                                *args[2:3], args[3][:0], *args[4:7], args[7][:0], args[8][:0])
    assert cuda_match.best_two.launches == before
    assert bool((empty[1] == -1).all()) and bool((empty[0] == cuda_match.INF).all())


def test_best_two_kernel_no_candidates_and_bad_input(cuda):
    args = list(_case(cuda, 64, 100, 256, True))
    args[8] = torch.zeros_like(args[8])
    b, i, s = cuda_match.best_two(*args)
    assert bool((i == -1).all()) and bool((b == cuda_match.INF).all())
    args[8] = args[8].to(torch.uint8)  # validity must be bool
    with pytest.raises(ValueError):
        cuda_match.best_two(*args)
    args = list(_case(cuda, 8, 8, 256, True))
    with pytest.raises(ValueError):
        cuda_match.best_two(args[0].cpu(), *args[1:])


@pytest.mark.parametrize("dim", [256, 384, 488, 512])
@pytest.mark.parametrize("n", [1, 7, 1000])
def test_pack_bits_ballot_equals_twin(cuda, dim, n):
    bits = torch.from_numpy(np.random.default_rng(n).integers(0, 2, (n, dim)).astype(np.uint8))
    before = cuda_match.pack_bits.launches
    got = cuda_match.pack_bits(bits.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), cuda_match.pack_bits_plain(bits))
    assert cuda_match.pack_bits.launches == before + 1


def _assert_packed_exact(args, dim):
    words = cuda_match.pack_bits(args[1])
    before = cuda_match.best_two.launches, cuda_match.pack_bits.launches
    b, i, s = cuda_match.best_two(args[0], words, *args[2:], c_dim=dim)
    rb, ri, rs = cuda_match.reference_best_two(*args)
    torch.cuda.synchronize()
    assert torch.equal(b, rb) and torch.equal(i.long(), ri) and torch.equal(s, rs)
    # one search launch and no pack: the queries are packed in the kernel
    assert (cuda_match.best_two.launches, cuda_match.pack_bits.launches) == (
        before[0] + 1, before[1])


@pytest.mark.parametrize("dim", [256, 384, 488, 512])
@pytest.mark.parametrize("nq,nc", [(1, 1), (300, 257), (1000, 1000), (4096, 1000)])
def test_best_two_packed_candidates_exact(cuda, dim, nq, nc):
    _assert_packed_exact(_case(cuda, nq, nc, dim, True), dim)


@pytest.mark.parametrize("dim", [256, 488, 512])
def test_best_two_tiled_candidates_exact(cuda, dim):
    # more candidates than one block stages whole: the double-buffered tiles
    _assert_packed_exact(_case(cuda, 700, 5000, dim, True, seed=1), dim)


@pytest.mark.parametrize("nq", [1, 528, 529, 1056, 1057, 2112, 2113, 4096, 8200])
def test_best_two_queries_per_block_boundaries(cuda, nq):
    # a query's candidates split over 8, 4, 2, 1 warps up to 528, 1056,
    # 2112 and above 2112 queries (csrc/best_two.cu launch_bits_split)
    _assert_packed_exact(_case(cuda, nq, 1000, 256, True, seed=2), 256)


@pytest.mark.parametrize("nq,nc", [(64, 96), (2048, 3000)])
def test_best_two_dense_ties_at_radius_inf(cuda, nq, nc):
    args = list(_case(cuda, nq, nc, 256, True, seed=3))
    half = nc // 2
    for k in (1, 3, 7, 8):  # every candidate row twice: exact ties everywhere
        args[k][half:2 * half] = args[k][:half]
    args[4] = torch.full_like(args[4], cuda_match.INF)
    args[5] = torch.zeros_like(args[5])
    args[6] = torch.full_like(args[6], cuda_match.INF)
    _assert_packed_exact(args, 256)
    b, i, s = cuda_match.best_two(*args)
    assert bool((i < half).all()) and bool((s == b).all())


def test_system_on_the_card_matches_the_cpu_port(cuda):
    """The System on the card (K1 and K2 launched) against the same code on
    the CPU (their plain twins) over the first 8 frames of the benchmark
    scene at 320x240, 600 features: the same initialization frame and
    initial points (integer results of the same searches); keyframe and
    point counts within 10% and the centres of keyframes minted at the same
    frames within 1e-2 map units, since BA sums in another order on the
    card (the tolerances of tests/test_torch_system.py)."""
    from types import SimpleNamespace

    from anyfeature_vslam_tpu_torch.system import System
    from torch_slice_scene import SliceScene

    sc = SliceScene(320, 240)
    frames = [sc.render(i)[0] for i in range(8)]
    runs = []
    for dev in (torch.device("cpu"), cuda):
        before = cuda_match.best_two.launches
        system = System(SimpleNamespace(**sc.camera), n_features=600, async_mapping=False,
                        device=dev)
        rows = [(system.track_monocular(img, i / 30.0).name, system.map.n_keyframes(),
                 system.map.n_points()) for i, img in enumerate(frames)]
        m = system.map
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


def test_place_recognition_and_geometry_on_the_card_match_the_cpu(cuda):
    """The relocalization and loop-closing maths on the card against the CPU
    port: vocabulary word ids exactly equal (integer distances, first
    minimum); batched RANSAC-EPnP and Sim3 RANSAC inlier sets equal, poses
    within 1e-4 (the same draws; float32 eigh / SVD in cuSOLVER); the pose
    graph within 1e-4."""
    import os

    from anyfeature_vslam_tpu_torch.ops import pnp, pose_graph, se3, sim3
    from anyfeature_vslam_tpu_torch.place_recognition import vocab

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    voc = vocab.Vocabulary.load(os.path.join(root, "vocabularies", "voc_orb32_38k.npz"))
    rng = np.random.default_rng(0)
    bits = torch.from_numpy(rng.integers(0, 2, (1000, 256)).astype(np.uint8))
    valid = torch.from_numpy(rng.random(1000) < 0.9)
    assert torch.equal(vocab.transform_words(voc, bits.to(cuda), valid.to(cuda)).cpu(),
                       vocab.transform_words(voc, bits, valid))

    def both(fn, *args, **kw):
        on_cpu = fn(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args), **kw)
        on_card = fn(*(torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray) else a
                       for a in args), **kw)
        return on_cpu, on_card

    # PnP: 3 candidates, 150 points, 30 outliers in one
    t = se3.se3_exp(torch.tensor([0.2, -0.1, 0.15, 0.08, -0.1, 0.05])).numpy()
    pts = rng.uniform([-2, -2, 4], [2, 2, 10], (3, 150, 3)).astype(np.float32)
    pc = pts @ t[:3, :3].T + t[:3, 3]
    uv = np.stack([500 * pc[..., 0] / pc[..., 2] + 320, 500 * pc[..., 1] / pc[..., 2] + 240],
                  -1).astype(np.float32)
    uv[1, :30] = rng.uniform([0, 0], [640, 480], (30, 2))
    pv = np.ones((3, 150), bool)
    pv[2, ::4] = False
    c, g = both(pnp.pnp_ransac_many, pts, uv, np.ones((3, 150), np.float32), pv,
                500.0, 500.0, 320.0, 240.0, 0)
    assert torch.equal(c["inliers"], g["inliers"].cpu())
    for k in ("r", "t"):
        assert float((c[k] - g[k].cpu()).abs().max()) < 1e-4, k
    # Sim3 RANSAC and LM on the pairs of one loop
    r = se3.so3_exp(torch.tensor([0.1, -0.3, 0.2])).numpy()
    pc2 = rng.uniform([-2, -2, 4], [2, 2, 10], (120, 3)).astype(np.float32)
    pc1 = (1.7 * pc2 @ r.T + np.array([0.4, -0.2, 0.3])).astype(np.float32)
    uv1 = (pc1[:, :2] / pc1[:, 2:] * 500 + [320, 240]).astype(np.float32)
    uv2 = (pc2[:, :2] / pc2[:, 2:] * 500 + [320, 240]).astype(np.float32)
    pc2[:20] += 2.0
    ones = np.ones(120, np.float32)
    v = np.ones(120, bool)
    c, g = both(sim3.sim3_ransac, pc1, pc2, uv1, uv2, ones, ones, v, 500.0, 500.0, 320.0, 240.0, 0)
    assert torch.equal(c["inliers"], g["inliers"].cpu())
    for k in ("r", "t", "s"):
        assert float((c[k] - g[k].cpu()).abs().max()) < 1e-4, k
    start = tuple(x.numpy() for x in (c["r"], c["t"])) + (float(c["s"]),)
    c, g = both(lambda *a: sim3.sim3_optimize(*start, *a, 500.0, 500.0, 320.0, 240.0),
                pc1, pc2, uv1, uv2, ones, ones, v)
    assert torch.equal(c["inliers"], g["inliers"].cpu())
    for k in ("r", "t", "s"):
        assert float((c[k] - g[k].cpu()).abs().max()) < 1e-4, k
    # pose graph: a drifted ring of 12 Sim3 vertices with one loop edge
    n = 12
    xi = np.zeros((n, 7), np.float32)
    xi[:, 3:6] = rng.normal(0, 0.3, (n, 3))
    xi[:, :3] = rng.normal(0, 1.0, (n, 3))
    rv, tv, sv = (x.numpy() for x in se3.sim3_exp7(torch.from_numpy(xi)))
    ei = np.arange(n, dtype=np.int64)
    ej = (ei + 1) % n
    noise = torch.from_numpy(rng.normal(0, 0.02, (n, 7)).astype(np.float32))
    meas = se3.sim3_compose(se3.sim3_exp7(noise), se3.sim3_compose(
        (torch.from_numpy(rv[ei]), torch.from_numpy(tv[ei]), torch.from_numpy(sv[ei])),
        se3.sim3_inv((torch.from_numpy(rv[ej]), torch.from_numpy(tv[ej]),
                      torch.from_numpy(sv[ej])))))
    fixed = np.zeros(n, bool)
    fixed[0] = True
    c, g = both(pose_graph.optimize_pose_graph, rv, tv, sv, np.ones(n, bool), fixed, ei, ej,
                *(x.numpy() for x in meas), np.ones(n, np.float32), np.ones(n, bool))
    for x, y in zip(c, g):
        assert float((x - y.cpu()).abs().max()) < 1e-4
