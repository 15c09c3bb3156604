"""The harness: cells, configurations, mixes and metrics found by name; the
result line; the counts of the yardstick; the imports of a run."""
from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from harness import common as C
from harness import counts

from _small import run_small


def _common_of(root):
    spec = importlib.util.spec_from_file_location(
        "bench_common_copy", os.path.join(root, "benchmark", "harness", "common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_a_new_cell_config_mix_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(C.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = C.benchmark_json()
    cfg = C.load_json(C.BENCH / "configs" / "yolov7-tiny.json")
    cfg["image_size"] = 320
    (root / "benchmark" / "configs" / "tiny320.json").write_text(json.dumps(cfg))
    mix = C.load_json(C.BENCH / "traffic" / "detect.val.json")
    mix["detect"]["batch"] = 8
    (root / "benchmark" / "traffic" / "detect.small.json").write_text(json.dumps(mix))
    (root / "benchmark" / "limits" / "tiny320.detect.small.json").write_text(
        json.dumps({"det_gap": 0.5, "missed": 0.5}))
    (root / "benchmark" / "metrics" / "images_per_call.py").write_text(
        "def read(ctx):\n    return ctx['items'] / ctx['calls']\n")
    bench["configs"].append({"name": "tiny320", "source": "https://example.org/tiny",
                             "file": "benchmark/configs/tiny320.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny320.detect.small", "config": "tiny320",
                               "traffic": "detect.small", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "images_per_call", "unit": "img", "better": "higher",
                               "source": "host_clock", "layer": "request",
                               "moves": "detect_img_s", "workloads": ["tiny320.detect.small"]})
    for m in bench["end_to_end"]:
        if m["name"] == "detect_img_s":
            m["workloads"].append("tiny320.detect.small")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    copy = _common_of(str(root))
    c = copy.cell("tiny320.detect.small")
    assert c["config"]["image_size"] == 320 and c["traffic"]["detect"]["batch"] == 8
    assert c["limits"] == {"det_gap": 0.5, "missed": 0.5}
    names = [m["name"] for m in copy.metrics_for(copy.benchmark_json(), "tiny320.detect.small",
                                                 True)]
    assert "images_per_call" in names and "detect_mfu" not in names
    assert copy.reader("images_per_call")({"items": 64, "calls": 8}) == 8
    assert [m["name"] for m in copy.metrics_for(copy.benchmark_json(),
                                                "tiny320.detect.small", False)] == \
        ["detect_img_s", "setup_s"]


def test_every_cell_file_and_metric_reader_is_there():
    bench = C.benchmark_json()
    for wl in bench["workloads"]:
        c = C.cell(wl["name"], bench)
        assert c["traffic"]["kind"] in ("train", "detect")
        e2e = {m["name"] for m in C.metrics_for(bench, wl["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = C.metrics_for(bench, wl["name"], True)
        assert per and all(m["moves"] in e2e for m in per)
    for m in bench["per_layer"]:
        assert callable(C.reader(m["name"]))


@pytest.mark.parametrize("name", ["yolov7.detect.val", "yolov7.train.stager",
                                  "yolov7-tiny.train.pool"])
def test_the_last_line_has_the_keys_the_driver_reads(name):
    res = run_small(name, seconds=1.0)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert res["attempted"] > 0 and res["failed"] == 0
    for chk in res["checks"].values():
        assert set(chk) == {"value", "limit"}
    json.dumps(res)


def test_without_a_card_the_command_exits_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "yolov7.detect.val", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=C.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_exits_without_a_result(tmp_path):
    shutil.copytree(C.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(C.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "yolov7.detect.val", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_counts_against_hand_worked_values():
    one_conv = {"num_classes": 1, "image_size": 8, "anchors": [[1, 1], [2, 2], [3, 3]],
                "anchors_mask": [[0], [1], [2]], "depth_multiple": 1.0, "width_multiple": 1.0,
                "backbone": [[-1, 1, "Conv", [4, 3, 1]], [-1, 1, "Conv", [4, 3, 2]],
                             [-1, 1, "Conv", [4, 3, 2]]],
                "head": [[[0, 1, 2], 1, "Detect", ["nc", "anchors"]]]}
    # convs: 8x8x4 outputs of 3x3x3, 4x4x4 of 3x3x4, 2x2x4 of 3x3x4; the head's
    # 1x1 convs from 4 to 6 channels (1 anchor, 6 outputs) at 8x8, 4x4 and 2x2
    macs = 64 * 4 * 27 + 16 * 4 * 36 + 4 * 4 * 36 + (64 + 16 + 4) * 6 * 4
    assert counts.forward_flops(one_conv) == 2 * macs
    assert counts.k3_bytes(32, 25200, 85) == 2 * 32 * 25200 * 85 * 4
    assert counts.k1_bytes(2, 300) == 2 * 300 * 22
    assert counts.iou_pairs([[1, 1, 1, 2], [3, 3]]) == 3 + 1
    assert counts.stage_letterbox_bytes(128, 640, 480, 640) == 128 * (640 * 480 * 3 + 640 ** 2 * 3)
    assert counts.head_rows(640) == 25200
    assert counts.forward_flops(C.load_json(C.BENCH / "configs" / "yolov7.json")) == \
        pytest.approx(105.77e9, rel=1e-3)


def test_readers_on_hand_worked_records():
    peaks = {"bf16_flops": 1e12, "fp32_flops": 1e11, "hbm_bytes_s": 1e9}
    trace = {"window_s": 2.0, "busy_s": 1.5,
             "kernels": {"void decode_levels_kernel<3>(Maps, Levels)": [0.004, 4],
                         "nms_suppress_kernel": [0.001, 4], "nms_tiled_mask_kernel": [9.0, 1],
                         "stage_letterbox_kernel(unsigned char const*)": [0.002, 2]}}
    ctx = {"trace": trace, "peaks": peaks, "window_s": 10.0, "items": 100, "steps": 4,
           "counts": {"forward_flops": 1e9, "k3_bytes": 1e6, "k1_bytes": 1e3,
                      "k1_pair_tests": 1000, "stage_letterbox_bytes": 5e5},
           "spans": {"data_wait": [0.5, 0.001, 0.002, 0.003, 0.004]},
           "events": {"augment": [1.0, 3.0], "train_step": [10.0, 20.0]}}
    r = lambda n: C.reader(n)(ctx)  # noqa: E731
    assert r("device_idle.train") == pytest.approx(25.0)
    assert r("decode_levels_tma_roofline") == pytest.approx(100 * 4 * 1e-3 / 0.004)
    # bytes bound it here: 1e3 B / 1e9 B/s = 1e-6 s over 13 * 1000 / 1e11 = 1.3e-7 s
    assert r("nms_suppress_roofline") == pytest.approx(100 * 4 * 1e-6 / 0.001)
    assert r("stage_letterbox_roofline") == pytest.approx(100 * 2 * 5e-4 / 0.002)
    assert r("train_mfu") == pytest.approx(100 * 3e9 * 100 / 10 / 1e12)
    assert r("detect_mfu") == pytest.approx(100 * 1e9 * 100 / 10 / 1e12)
    assert r("data_wait_ms.train") == pytest.approx(10 / 4)
    assert r("augment_ms.train") == 2.0 and r("train_step_ms") == 15.0
    empty = {"trace": None, "counts": {}, "peaks": peaks}
    for n in ("stage_letterbox_roofline", "decode_levels_tma_roofline", "device_idle.detect"):
        assert C.reader(n)(empty) is None


def test_weights_and_images_come_from_the_seed():
    from reference.model import state_shapes
    cfg = C.load_json(C.BENCH / "configs" / "yolov7-tiny.json")
    a = C.make_weights(state_shapes(cfg), 2 ** 40 + 3, "cpu")
    b = C.make_weights(state_shapes(cfg), 2 ** 40 + 3, "cpu")
    c = C.make_weights(state_shapes(cfg), 2 ** 40 + 4, "cpu")
    assert all(np.array_equal(a[k].numpy(), b[k].numpy()) for k in a)
    w = a["model.0.conv.weight"]
    assert not np.array_equal(w.numpy(), c["model.0.conv.weight"].numpy())
    assert abs(float(w.std()) - 27 ** -0.5) < 0.05
    d1, b1 = C.jpegs(4, 2 ** 33, 64, 48, 1)
    d2, b2 = C.jpegs(4, 2 ** 33, 64, 48, 1)
    assert d1 == d2 and all(np.array_equal(x, y) for x, y in zip(b1, b2))


IMPORT_CHECK = """
import sys
sys.path[:0] = ['benchmark', '.']
{body}
top = {{m.split('.')[0] for m in list(sys.modules)}}
print(sorted(top & {{'jax', 'jaxlib', 'flax', 'yolo_continuous_tpu', 'yolo_continuous_tpu_torch'}}))
"""


def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_port():
    body = ("import reference.model, reference.train, reference.postprocess, "
            "reference.compare, reference.staging\n"
            "from reference.model import forward_flops\n")
    out = subprocess.run([sys.executable, "-c", IMPORT_CHECK.format(body=body)], cwd=C.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    body = ("sys.path.insert(0, 'benchmark/tests')\n"
            "from _small import run_small\n"
            "for n in ('yolov7.detect.val', 'yolov7.train.stager', 'yolov7-tiny.train.pool'):\n"
            "    run_small(n, seconds=0.5)\n")
    out = subprocess.run([sys.executable, "-c", IMPORT_CHECK.format(body=body)], cwd=C.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "['yolo_continuous_tpu_torch']"
