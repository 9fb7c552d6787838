"""The port's offline tools (anyfeature_vslam_tpu_torch/tools/) against the
JAX package's (tools/*.py) on the same inputs, on the CPU.

Tolerances and why:
- evaluate_ate: the same JSON within 1e-6 (the same numpy code);
- make_synth_sequence: rgb.csv, groundtruth.csv and calibration.yaml
  byte-identical, the frames' pixels equal (PIL wrote JAX's, zlib the
  port's);
- create_vocabulary (orb32, 4 frames at 320x240, branching 8, depth 2):
  on the same descriptor rows the centroids equal and the idf within 1e-6
  (the same numpy k-means and generator); each tool's own extraction
  differs in a few rows (the port's fp32 pyramid against JAX's bf16x3
  one, tests/test_torch_families.py), so the port's tool is held on JAX's
  rows;
- learned48: init_params equal; one loss value within 1e-5 relative and
  each gradient within 1e-5 of its largest entry (fp32 products in another
  order); five Adam steps on the same gradients within 1e-6 of optax's;
  both training tools' saved weights after 3 steps within 2e-4 (measured
  5.4e-5: Adam's first steps divide each gradient by its own magnitude,
  so the entries whose gradients are near 0 carry the fp32 differences
  of the gradients into the weights).
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from anyfeature_vslam_tpu_torch import convert
from anyfeature_vslam_tpu_torch.frontend import learned48 as tl48
from anyfeature_vslam_tpu_torch.io import dataset as tdataset
from anyfeature_vslam_tpu_torch.tools import create_vocabulary as tvoc
from anyfeature_vslam_tpu_torch.tools import evaluate_ate as tate
from anyfeature_vslam_tpu_torch.tools import make_synth_sequence as tseq
from anyfeature_vslam_tpu_torch.tools import train_patch_descriptor as ttrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 320, 240
TEXT_FILES = ("rgb.csv", "groundtruth.csv", "calibration.yaml")


def _jax_tool(name):
    """tools/<name>.py, the JAX package's tool, as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    """The 4-frame 320x240 sequence written by both tools."""
    base = tmp_path_factory.mktemp("seq")
    args = ["n_frames:4", f"width:{W}", f"height:{H}", "revisit:0.2", "seed:3"]
    port, jax = str(base / "port"), str(base / "jax")
    assert tseq.main([f"out_dir:{port}"] + args) == 0
    assert _jax_tool("make_synth_sequence").main([f"out_dir:{jax}"] + args) == 0
    return port, jax


def test_evaluate_ate_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(0)
    xyz = np.cumsum(rng.normal(0, 0.05, (60, 3)), axis=0)
    ang = 0.3
    r = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    est = 0.7 * xyz @ r.T + [1.0, -2.0, 0.5] + rng.normal(0, 0.01, xyz.shape)
    gt_path, est_path = str(tmp_path / "gt.txt"), str(tmp_path / "est.txt")
    for path, pts, dt in ((gt_path, xyz, 0.0), (est_path, est, 0.004)):
        with open(path, "w") as f:
            for i, p in enumerate(pts):
                f.write(f"{i / 30 + dt:.6f} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f} 0 0 0 1\n")
    outs = []
    for main in (tate.main, _jax_tool("evaluate_ate").main):
        assert main([f"est:{est_path}", f"gt:{gt_path}", "max_diff:0.02"]) == 0
        outs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    got, want = outs
    assert set(got) == set(want) == {"ate_rmse", "n_pairs", "scale"}
    assert got["n_pairs"] == want["n_pairs"] == 60
    for k in ("ate_rmse", "scale"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got, want)
    assert tate.main(["est:x"]) == 1


def test_make_synth_sequence_matches_jax(sequences):
    port, jax = sequences
    for name in TEXT_FILES:
        with open(os.path.join(port, name), "rb") as a, open(os.path.join(jax, name), "rb") as b:
            assert a.read() == b.read(), name
    for i in range(4):
        rel = f"rgb/{i:06d}.png"
        with Image.open(os.path.join(jax, rel)) as im:
            want = np.asarray(im)
        got = tdataset.load_gray(os.path.join(port, rel))
        assert np.array_equal(got, want.astype(np.float32)), rel


def test_make_synth_sequence_cut_and_workers(tmp_path):
    """max_frames cuts the bench trajectory (150 frames) to its first
    frames, which equal tests/torch_slice_scene.py's in-memory ones; the
    tool's poses_for and write_sequence_files, which chip_smoke.py uses to
    write the frames it rendered itself, give the tool's text files."""
    from torch_slice_scene import SliceScene

    out, again = str(tmp_path / "cut"), str(tmp_path / "again")
    assert tseq.main([f"out_dir:{out}", "n_frames:150", "max_frames:3",
                      f"width:{W}", f"height:{H}", "revisit:0.2", "seed:3"]) == 0
    sc = SliceScene(W, H)
    for i in range(3):
        got = tdataset.load_gray(os.path.join(out, f"rgb/{i:06d}.png"))
        assert np.array_equal(got, sc.render(i)[0].astype(np.float32))
    seq = tdataset.load_sequence(out)
    assert len(seq.image_paths) == 3 and seq.camera.width == W
    os.makedirs(again)
    tseq.write_sequence_files(again, tseq.poses_for("circle", 150, 0.2, 0.8)[:3], 30.0, W, H)
    for name in ("rgb.csv", "groundtruth.csv", "calibration.yaml"):
        with open(os.path.join(out, name), "rb") as a, open(os.path.join(again, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(out, "groundtruth.csv")) as f:
        assert len(f.read().splitlines()) == 4


def test_create_vocabulary_matches_jax(sequences, tmp_path, monkeypatch):
    """orb32 over 4 frames, branching 8, depth 2. The port's tool on JAX's
    descriptor rows writes JAX's tree (the extractions differ in a few
    rows, whose k-means moves the centroids); on its own rows it writes a
    file JAX's loader reads."""
    import jax.numpy as jnp

    from anyfeature_vslam_tpu.frontend import extractor as jext
    from anyfeature_vslam_tpu.place_recognition import vocab as jvocab
    from anyfeature_vslam_tpu_torch.place_recognition import vocab as tvocab

    port_seq, jax_seq = sequences
    args = ["feature:orb32", "sample_every:1", "max_frames:4", "branching:8", "depth:2"]
    out_t, out_j, out_own = (str(tmp_path / f"{n}.npz") for n in ("port", "jax", "own"))
    assert _jax_tool("create_vocabulary").main([f"sequence_path:{jax_seq}",
                                                f"out:{out_j}"] + args) == 0
    assert tvoc.main([f"sequence_path:{port_seq}", f"out:{out_own}", "device:cpu"] + args) == 0

    def jax_rows(paths, cfg, device, log=print):
        jcfg = jext.ExtractorConfig.for_feature("orb32", n_features=cfg.n_features)
        out = []
        for p in paths:
            img = tdataset.load_gray(p)
            f = jext.extract_features(jnp.asarray(img), jcfg, *img.shape)
            out.append(np.asarray(f["desc_bits"])[np.asarray(f["valid"])])
        return out

    monkeypatch.setattr(tvoc, "extract_descriptors", jax_rows)
    assert tvoc.main([f"sequence_path:{port_seq}", f"out:{out_t}", "device:cpu"] + args) == 0
    got, want = tvocab.Vocabulary.load(out_t), jvocab.Vocabulary.load(out_j)
    assert (got.branching, got.depth) == (want.branching, want.depth) == (8, 2)
    for a, b in zip(got.centroids, want.centroids):
        assert a.dtype == np.asarray(b).dtype == np.uint8 and np.array_equal(a, np.asarray(b))
    np.testing.assert_allclose(got.idf, np.asarray(want.idf), atol=1e-6, rtol=0)
    own, back = tvocab.Vocabulary.load(out_own), jvocab.Vocabulary.load(out_own)
    assert own.n_words == 64 and own.centroids[-1].shape == (64, 256)
    for a, b in zip(back.centroids, own.centroids):
        assert np.array_equal(np.asarray(a), b)


def test_create_vocabulary_rejects_r2d2(sequences):
    with pytest.raises(ValueError, match="precomputed"):
        tvoc.main([f"sequence_path:{sequences[0]}", "feature:r2d2_128", "device:cpu"])
    assert tvoc.main([]) == 1


def test_learned48_init_and_weights_roundtrip():
    from anyfeature_vslam_tpu.frontend import learned48 as jl48

    for seed in (0, 3):
        got, want = tl48.init_params(seed), jl48.init_params(seed)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    params = tl48.init_params(1)
    back = convert.learned48_to_numpy(convert.learned48_from_numpy(params, "cpu"))
    for k in params:
        assert back[k].dtype == np.float32 and np.array_equal(back[k], params[k]), k


def _pairs(n=96, seed=5):
    """Real (anchor, positive) patches: the port tool's sampler on a one-
    image synthetic corpus, on the CPU."""
    rng = np.random.default_rng(seed)
    imgs = np.stack(ttrain.synthetic_corpus(rng, 1))
    pa, pb = ttrain.PairSampler(imgs, rng, torch.device("cpu"))(n)
    return pa.numpy(), pb.numpy()


def _jax_loss(margin):
    """tools/train_patch_descriptor.py:158-170's loss_fn."""
    import jax
    import jax.numpy as jnp

    from anyfeature_vslam_tpu.frontend import learned48 as jl48

    def loss_fn(p, pa, pb):
        da = jl48.mlp_forward(p, pa)
        db = jl48.mlp_forward(p, pb)
        d2 = jnp.clip(2.0 - 2.0 * da @ db.T, 0.0, None)
        d = jnp.sqrt(d2 + 1e-9)
        pos = jnp.diagonal(d)
        big = 10.0 * jnp.eye(d.shape[0])
        neg_row = jnp.min(d + big, axis=1)
        neg_col = jnp.min(d + big, axis=0)
        neg = jnp.minimum(neg_row, neg_col)
        loss = jnp.mean(jax.nn.relu(margin + pos - neg))
        return loss, (jnp.mean(pos), jnp.mean(neg))
    return loss_fn


def test_loss_and_gradients_match_jax():
    import jax
    import jax.numpy as jnp

    pa, pb = _pairs()
    params = tl48.init_params(2)
    (j_loss, (j_pos, j_neg)), j_grads = jax.value_and_grad(_jax_loss(1.0), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(pa), jnp.asarray(pb))
    mlp = convert.learned48_from_numpy(params, "cpu").requires_grad_(True)
    loss, pos, neg = ttrain.loss_fn(mlp, torch.from_numpy(pa), torch.from_numpy(pb), 1.0)
    loss.backward()
    for got, want in ((loss, j_loss), (pos, j_pos), (neg, j_neg)):
        assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
    grads = {}
    for k, layer in enumerate((mlp.fc1, mlp.fc2, mlp.fc3), start=1):
        grads[f"w{k}"] = layer.weight.grad.numpy().T
        grads[f"b{k}"] = layer.bias.grad.numpy()
    for k, want in j_grads.items():
        want = np.asarray(want)
        assert np.abs(grads[k] - want).max() <= 1e-5 * np.abs(want).max(), k


def test_adam_steps_match_optax():
    import jax.numpy as jnp
    import optax

    params = tl48.init_params(4)
    rng = np.random.default_rng(9)
    grads = [{k: (rng.normal(0, 1e-2, v.shape) * (rng.random(v.shape) < 0.9)).astype(np.float32)
              for k, v in params.items()} for _ in range(5)]
    opt = optax.adam(1e-3)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(j_params)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state)
        j_params = optax.apply_updates(j_params, updates)
    mlp = convert.learned48_from_numpy(params, "cpu").requires_grad_(True)
    t_opt = ttrain.make_optimizer(mlp, 1e-3)
    for g in grads:
        for k, layer in enumerate((mlp.fc1, mlp.fc2, mlp.fc3), start=1):
            layer.weight.grad = torch.from_numpy(np.ascontiguousarray(g[f"w{k}"].T))
            layer.bias.grad = torch.from_numpy(g[f"b{k}"])
        t_opt.step()
    got = convert.learned48_to_numpy(mlp)
    for k, want in j_params.items():
        np.testing.assert_allclose(got[k], np.asarray(want), atol=1e-6, rtol=0, err_msg=k)


def test_train_patch_descriptor_matches_jax(tmp_path, capsys):
    """Both tools' main, seed 0, a 2-image synthetic corpus, 3 steps of 64
    pairs: the same printed lines, the saved weights within 2e-4."""
    args = ["sequence_path:synthetic", "seed:0", "n_corpus:2", "steps:3", "batch:64"]
    out_t, out_j = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert ttrain.main(args + [f"out:{out_t}", "device:cpu"]) == 0
    lines_t = capsys.readouterr().out.splitlines()
    assert _jax_tool("train_patch_descriptor").main(args + [f"out:{out_j}"]) == 0
    lines_j = capsys.readouterr().out.splitlines()
    assert lines_t[:-1] == lines_j[:-1] and lines_t[-1] == f"saved {out_t}"
    with np.load(out_t) as got, np.load(out_j) as want:
        assert set(got.files) == set(want.files) == {"w1", "b1", "w2", "b2", "w3", "b3"}
        for k in want.files:
            assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k], want[k], atol=2e-4, rtol=0, err_msg=k)
    assert ttrain.main([]) == 1


def test_bench_ba_runs_on_cpu(capsys):
    """bench_ba's problems are JAX's, draw for draw; a small run with two
    gloo ranks prints every line."""
    from anyfeature_vslam_tpu_torch.tools import bench_ba

    for got, want in zip(bench_ba.make_problem(8, 50, 300, seed=1),
                         _jax_tool("bench_ba").make_problem(8, 50, 300, seed=1)):
        assert np.array_equal(np.asarray(got), np.asarray(want))
    assert bench_ba.main(["--cpu", "--mesh", "2", "--scale", "64", "--iters", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("backend: cpu")
    assert [l.split(":")[0] for l in lines[1:3]] == ["local_ba", "global_ba"]
    assert all("mean chi2=" in l and l.endswith("(cpu)") for l in lines[1:3])
    assert [l.split(":")[0] for l in lines[3:]] == [
        "point_sharded global_ba on 1 devices", "point_sharded global_ba on 2 devices"]


@pytest.mark.parametrize("name", ["profile_detect", "profile_tracking"])
def test_profile_tools_run_on_cpu(name, capsys):
    """Each stage over one frame on the CPU: a finite ms per frame."""
    import importlib

    tool = importlib.import_module(f"anyfeature_vslam_tpu_torch.tools.{name}")
    assert tool.main(["n_frames:1", "device:cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [l.split()[0] for l in lines] == list(tool.STAGES)
    for line in lines:
        ms = float(line.split()[1])
        assert np.isfinite(ms) and ms > 0 and line.endswith("ms/frame (cpu)")
