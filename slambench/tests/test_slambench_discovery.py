"""A configuration, a traffic mix, a cell's limits and a per-layer metric
are files of their own, found by the names in BENCHMARK.json: a new cell
or metric needs new files and entries only."""

import json
import shutil

from slambench import harness


def test_every_cell_of_the_benchmark_finds_its_files():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        spec = harness.load_cell(w["name"])
        assert spec["config"]["name"] == w["config"]
        assert set(spec["limits"]) == {"ate_cm", "frontend_bad_pct", "k2_gap", "lost_pct"}
        assert {m["name"] for m in spec["end_to_end"]} >= {"frames_per_s", "setup_s"}
        for m in spec["per_layer"]:
            assert callable(harness.metric_reader(m["name"]))


# orb32's cell, out of BENCHMARK.json (PERF.md, Open questions), whose
# files stay in the benchmark's folder: a later PR adds it back by entries
ORB32 = dict(name="orb32_tum1", source="https://github.com/raulmur/ORB_SLAM2",
             file="slambench/configs/orb32_tum1.json",
             reduced=["Camera.k1", "Camera.k2", "Camera.p1", "Camera.p2", "Camera.k3",
                      "ORBextractor.minThFAST"], why="a test configuration")


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / harness.HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    here = tmp_path / harness.HERE.name
    traffic = harness.load_json(here / "traffic" / "revisit.json")
    traffic["path"]["period_frames"] = 120
    (here / "traffic" / "slow_sweep.json").write_text(json.dumps(traffic))
    (here / "limits" / "orb32_tum1.slow_sweep.json").write_text(
        (here / "limits" / "orb32_tum1.revisit.json").read_text())
    (here / "metrics" / "frames_seen.py").write_text("def read(run):\n    return run['frames']\n")
    bench["configs"].append(ORB32)
    bench["workloads"].append(dict(name="orb32_tum1.slow_sweep", config="orb32_tum1",
                                   traffic="slow_sweep", chips=1, why="a test cell"))
    bench["per_layer"].append(dict(name="frames_seen", unit="frames", better="higher",
                                   source="program_counter", layer="schedules",
                                   moves="frames_per_s", workloads=["orb32_tum1.slow_sweep"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = harness.load_cell("orb32_tum1.slow_sweep", root=tmp_path)
    assert spec["traffic"]["path"]["period_frames"] == 120
    assert [m["name"] for m in spec["per_layer"]][-1] == "frames_seen"
    assert harness.metric_reader("frames_seen", spec["dir"])({"frames": 7}) == 7
    # the cells already there do not see the new metric
    assert "frames_seen" not in {m["name"] for m in
                                 harness.load_cell("sift128_tum1.explore", root=tmp_path)["per_layer"]}


# ORB-SLAM2's Examples/Monocular/TUM1.yaml, the source of both configurations
TUM1 = {"Camera.fx": 517.306408, "Camera.fy": 516.469215, "Camera.cx": 318.643040,
        "Camera.cy": 255.313989, "Camera.k1": 0.262383, "Camera.k2": -0.953104,
        "Camera.p1": -0.005358, "Camera.p2": 0.002628, "Camera.k3": 1.163314,
        "Camera.fps": 30.0, "Camera.RGB": 1, "ORBextractor.nFeatures": 1000,
        "ORBextractor.scaleFactor": 1.2, "ORBextractor.nLevels": 8,
        "ORBextractor.iniThFAST": 20, "ORBextractor.minThFAST": 7}


def test_a_configuration_states_each_value_once_and_lists_what_departs_from_its_source():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for c in bench["configs"] + [ORB32]:
        raw = harness.load_json(harness.ROOT / c["file"])
        assert not {"camera", "n_features"} & set(raw) and "n_features" not in raw["feature"]
        departs = {k for k, v in TUM1.items() if raw.get(k) != v}
        assert departs == set(c["reduced"]), c["name"]
        assert set(c["reduced"]) <= set(raw["assumed"])
        config = harness.configuration(raw)
        cam = config["camera"]
        assert (cam["fx"], cam["cy"], cam["k1"], cam["fps"]) == (
            raw["Camera.fx"], raw["Camera.cy"], raw["Camera.k1"], raw["Camera.fps"])
        assert config["feature"]["n_features"] == raw["ORBextractor.nFeatures"]
    orb = harness.load_config(harness.HERE / "configs" / "orb32_tum1.json")
    assert orb["feature"]["settings"] == dict(n_levels=8, scale_factor=1.2, detect_th=20.0)
