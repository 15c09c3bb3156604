"""The port's bench (``yolo_continuous_tpu_torch/bench.py``) against the root ``bench.py``.

- Inputs: the train batch, the NVAR infer inputs and the NMS ``preds``
  equal the arrays the JAX bench draws (its ``RandomState(0)`` calls of
  bench.py:125-132 and 225-240, written out here in the same order).
- The timed infer function: on the bench's first input plus a carry, the
  port's step on yolov7-tiny @64 (80 classes, bf16 head, fp32 body on the
  CPU) gives JAX's ``Detector(plan, head_dtype=bfloat16)._build_infer(0.25,
  0.45, 300)`` detections on the same ``lively`` weights (through
  ``tools/jax_weights``), to the bf16-head tolerances of
  test_torch_port_fuse.py: maps within one bf16 step, detections to 1e-4,
  classes exact. bf16 logits tie a few scores, whose order in the output
  neither function fixes, so each image's detections are compared sorted.
  ``nms_single`` on one full 25,200 x 85 ``preds`` draw equals JAX's
  exactly, keep-set and order.
- The sections run on the CPU (yolov7-tiny @64, batch 2) and give every
  key of the JAX bench, finite and > 0.
- The orchestrator, with ``_run_section`` replaced: every section's keys in
  the last line, a timed-out section in ``error``, the global deadline
  skipping sections, ``vs_baseline = value / 55``; a probe that finds no
  card stops it. Then in a real process: SIGTERM after the probe line
  exits 0 with a parseable last line, and ``--device cuda`` without a card
  records the probe's error and runs no section.
"""
import json
import math
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import lively, min_score_gap
from yolo_continuous_tpu.config.plan import TrainPlan as JaxPlan
from yolo_continuous_tpu.config.plan import cvt_cfg as jax_cvt_cfg
from yolo_continuous_tpu.detect_api import Detector as JaxDetector
from yolo_continuous_tpu.nn.builder import YoloModel as JaxModel
from yolo_continuous_tpu.nn.builder import build_model_spec as jax_spec
from yolo_continuous_tpu.ops.nms import nms_single as jax_nms_single
from yolo_continuous_tpu_torch import bench
from yolo_continuous_tpu_torch.detect_api import Detector
from yolo_continuous_tpu_torch.ops.nms import nms_single
from yolo_continuous_tpu_torch.tools.jax_weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, BATCH = 64, 2
TINY = {"model_cfg": "cfg/net/yolov7-tiny.yaml"}
INFER_KEYS = ("infer_img_s", "infer_1_ms", "nms_p50_ms", "infer_1_ms_fused_tails",
              "infer_img_s_int8")


def _jax_train_batch(batch, size):
    """bench.py:125-132."""
    rs = np.random.RandomState(0)
    images = jnp.asarray(rs.rand(batch, size, size, 3), jnp.float32)
    labels = np.zeros((batch, 64, 5), np.float32)
    labels[:, 0] = [1, 0.5, 0.5, 0.4, 0.4]
    labels[:, 1] = [3, 0.3, 0.3, 0.2, 0.25]
    lmask = np.zeros((batch, 64), bool)
    lmask[:, :2] = True
    return np.asarray(images), labels, lmask


def _jax_infer_inputs(batch, size):
    """bench.py:206-240: the draws in their order (the timed runs between
    them draw nothing)."""
    NVAR = 4
    rs = np.random.RandomState(0)
    variants = [jnp.asarray(rs.rand(batch, size, size, 3), jnp.float32) for _ in range(NVAR)]
    singles = [jnp.asarray(rs.rand(1, size, size, 3), jnp.float32) for _ in range(NVAR)]
    preds = [jnp.asarray(
        np.concatenate([rs.rand(25200, 2), rs.rand(25200, 2) * 0.1 + 0.01,
                        rs.rand(25200, 1), rs.rand(25200, 80)], -1),
        jnp.float32) for _ in range(NVAR)]
    return [[np.asarray(a) for a in arrays] for arrays in (variants, singles, preds)]


@pytest.fixture(scope="module")
def infer_draws():
    return bench.infer_inputs(BATCH, SIZE), _jax_infer_inputs(BATCH, SIZE)


def test_train_batch_is_the_jax_bench_draw():
    for ours, ref in zip(bench.train_batch(BATCH, SIZE), _jax_train_batch(BATCH, SIZE)):
        assert ours.dtype == ref.dtype and ours.shape == ref.shape
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("which,shape", [(0, (BATCH, SIZE, SIZE, 3)), (1, (1, SIZE, SIZE, 3)),
                                         (2, (25200, 85))], ids=["variants", "singles", "preds"])
def test_infer_inputs_are_the_jax_bench_draws(infer_draws, which, shape):
    ours, ref = infer_draws[0][which], infer_draws[1][which]
    assert len(ours) == len(ref) == bench.NVAR
    for a, b in zip(ours, ref):
        assert a.dtype == np.float32 and a.shape == shape
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def tiny_weights():
    """lively JAX weights of yolov7-tiny with the bench plan's 80 classes,
    and the port's state dict of them."""
    cfg = bench.plan_cfg(SIZE, TINY)
    model = JaxModel(spec=jax_spec(jax_cvt_cfg(cfg["model_cfg"]), 3, cfg["anchors"], 80))
    v = jax.eval_shape(lambda k, a: model.init(k, a, False), jax.random.PRNGKey(0),
                       jnp.zeros((1, SIZE, SIZE, 3)))
    rs = np.random.RandomState(3)
    params, stats = lively(v["params"], rs), lively(v["batch_stats"], rs)
    return cfg, params, stats, state_dict_from_jax(model.spec, params, stats)


def _sorted_detections(out, i):
    """Image ``i``'s valid detections as rows (score, class, box), sorted."""
    valid = np.asarray(out[3][i]).astype(bool)
    rows = np.concatenate([np.asarray(out[1][i])[valid][:, None],
                           np.asarray(out[2][i])[valid][:, None].astype(np.float32),
                           np.asarray(out[0][i])[valid]], 1)
    return rows[np.lexsort(rows.T[::-1])]


def test_timed_infer_function_matches_jax_build_infer(tiny_weights, infer_draws):
    cfg, params, stats, sd = tiny_weights
    x = infer_draws[0][0][0]
    det = Detector(bench.infer_plan(SIZE, TINY), device="cpu", state_dict=sd,
                   head_dtype=torch.bfloat16)
    jplan = JaxPlan(dict(cfg))
    jplan.save_path = "/nonexistent/x.msgpack"
    jdet = JaxDetector(jplan, params=params, batch_stats=stats, head_dtype=jnp.bfloat16)
    assert jdet.dtype == jnp.float32 and det.dtype == torch.float32     # the CPU's body dtype

    step = bench.infer_step(det)
    carry = bench.chain_of(step(torch.from_numpy(x), torch.zeros(())))   # the second call's carry
    assert 0 < float(carry) < 1e-8
    ours = step(torch.from_numpy(x), carry)
    ref = jdet._build_infer(0.25, 0.45, 300)(jdet.params, jdet.batch_stats,
                                            jnp.asarray(x) + jnp.float32(float(carry)))

    apply = jax.jit(jdet.model.apply, static_argnums=2)
    jmaps = apply({"params": jdet.params, "batch_stats": jdet.batch_stats},
                  jnp.asarray(x) + jnp.float32(float(carry)), False)
    for o, r in zip(det.forward(x + carry.numpy()), jmaps):
        assert o.dtype == torch.bfloat16
        # one bf16 step: the fp32 sums round to bf16 from a different order
        np.testing.assert_allclose(o.float().numpy(), np.asarray(r, np.float32),
                                   rtol=2 ** -7, atol=1e-6)
    valid = np.asarray(ref[3])
    np.testing.assert_array_equal(ours[3].numpy().sum(1), valid.sum(1))
    assert 0 < valid.sum(1).min() and valid.sum(1).max() < 252        # NMS dropped some
    for i in range(BATCH):
        a, b = _sorted_detections([t.numpy() for t in ours], i), _sorted_detections(ref, i)
        np.testing.assert_array_equal(a[:, 1], b[:, 1])                 # classes
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    # the bench's conf threshold is not on a knife edge here
    score = ours[1].numpy()[ours[3].numpy()]
    assert np.abs(score - 0.25).min() > 1e-3


def test_nms_single_matches_jax_exactly(infer_draws):
    p = infer_draws[0][2][0]
    ours = nms_single(torch.from_numpy(p), 0.25, 0.45, 300)
    ref = jax_nms_single(jnp.asarray(p), 0.25, 0.45, 300)
    score = p[:, 4] * p[:, 5:].max(-1)
    assert min_score_gap(np.where(score >= 0.25, score, -1.0)[None], 300) > 0   # no tied rank
    np.testing.assert_array_equal(ours[3].numpy(), np.asarray(ref[3]))         # keep-set, in order
    assert int(ours[3].sum()) > 0     # (random boxes of 80 classes: the top 300 rarely overlap)
    for o, r in zip(ours[:3], ref[:3]):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("mode", sorted(bench.TRAIN_MODES))
def test_bench_train_gives_a_rate(mode):
    ips = bench.bench_train(BATCH, size=SIZE, iters=2, extra_cfg={**TINY, **bench.TRAIN_MODES[mode]},
                            device="cpu")
    assert math.isfinite(ips) and ips > 0


def test_bench_train_feeds_bf16_images(monkeypatch):
    """scripts/throughput_sweep.py's ``bf16-img`` mode: the step is handed
    the batch as bf16 (the JAX bench's ``image_dtype``)."""
    from yolo_continuous_tpu_torch.train.train_loop import Trainer
    seen, step = [], Trainer.train_step

    def spy(self, state, images, *rest):
        seen.append(images.dtype)
        return step(self, state, images, *rest)

    monkeypatch.setattr(Trainer, "train_step", spy)
    ips = bench.bench_train(BATCH, size=SIZE, iters=1, extra_cfg=TINY, image_dtype="bfloat16",
                            device="cpu")
    assert math.isfinite(ips) and ips > 0
    assert seen == [torch.bfloat16] * 3       # the warm step and two passes of one


def test_section_train_prints_the_sweep_keys(monkeypatch, capsys):
    monkeypatch.setattr(bench, "bench_train", lambda b, extra_cfg=None, device="cuda": 10.0 * b)
    bench.section_train([2, 4], "bn_remat", device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line) for line in lines] == [
        {"train_sweep": {"2/bn_remat": 20.0}},
        {"train_sweep": {"2/bn_remat": 20.0, "4/bn_remat": 40.0}}]


def test_section_infer_gives_every_jax_key(capsys):
    bench.section_infer(batch=BATCH, size=SIZE, iters=2, extras=("fused_tails", "int8"),
                        device="cpu", extra_cfg=TINY)
    captured = capsys.readouterr()
    lines = [json.loads(line) for line in captured.out.strip().splitlines()]
    assert list(lines[-1]) == list(INFER_KEYS)              # JAX's keys, in its order
    assert all(math.isfinite(v) and v > 0 for v in lines[-1].values())
    passes = [json.loads(line[len(bench.PASSES):]) for line in captured.err.splitlines()
              if line.startswith(bench.PASSES)]
    assert [p["key"] for p in passes] == list(INFER_KEYS)
    assert all(len(p["pass_ms"]) == 2 for p in passes if p["key"] != "nms_p50_ms")
    nms = passes[2]
    assert len(nms["call_ms"]) == bench.NMS_CALLS
    assert lines[-1]["nms_p50_ms"] == round(float(np.median(nms["call_ms"])), 3)


# --------------------------------------------------------------------------- orchestrator

SECTION_OUT = {
    "probe": {"ok": True, "backend": "cpu", "sum": 2097152.0},
    "train": {"train_sweep": {"16": 110.0}},
    "infer": {"infer_img_s": 600.0, "infer_1_ms": 25.0, "nms_p50_ms": 0.5,
              "infer_1_ms_fused_tails": 24.0, "infer_img_s_int8": 200.0},
}


def _fake_sections(calls, fail=None):
    def run(args, timeout):
        calls.append((args, timeout))
        name = args[args.index("--section") + 1]
        if name == "train" and "bn_remat" in args:
            out = {"train_sweep": {"16/bn_remat": 70.0}}
        else:
            out = SECTION_OUT[name]
        if fail == name:
            return None, f"{args}: timeout after {timeout:.0f}s"
        return out, None
    return run


def _last_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_orchestrator_line_holds_every_section(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(bench, "_run_section", _fake_sections(calls))
    monkeypatch.setenv("BENCH_TRAIN_MODES", "base,bn_remat")
    monkeypatch.setenv("BENCH_INFER_EXTRAS", "fused_tails,int8")
    result = bench.orchestrate(["16"], "cpu")
    line = _last_line(capsys)
    assert line == result and "error" not in line
    assert line["value"] == 110.0 and line["train_best_bs"] == "16"
    assert line["train_sweep"] == {"16": 110.0, "16/bn_remat": 70.0}
    assert line["vs_baseline"] == round(110.0 / 55.0, 3)
    assert all(line[k] == v for k, v in SECTION_OUT["infer"].items())
    assert line["device"] == {"backend": "cpu"}
    assert [a for a, _ in calls] == [
        ["--device", "cpu", "--section", "probe"],
        ["--device", "cpu", "--section", "train", "--mode", "base", "16"],
        ["--device", "cpu", "--section", "train", "--mode", "bn_remat", "16"],
        ["--device", "cpu", "--section", "infer", "fused_tails", "int8"]]
    # the infer reserve is kept from the train sections' timeouts
    assert calls[1][1] <= bench.TOTAL_BUDGET - bench.INFER_RESERVE


def test_orchestrator_records_a_timed_out_section(monkeypatch, capsys):
    monkeypatch.setattr(bench, "_run_section", _fake_sections([], fail="infer"))
    monkeypatch.delenv("BENCH_TRAIN_MODES", raising=False)
    bench.orchestrate(["16"], "cpu")
    line = _last_line(capsys)
    assert "timeout after" in line["error"] and "infer" in line["error"]
    assert line["value"] == 110.0 and "infer_img_s" not in line


@pytest.mark.parametrize("budget,skipped", [(300, ["train mode base skipped"]),
                                            (100, ["train mode base skipped", "infer skipped"])])
def test_the_global_deadline_skips_sections(monkeypatch, capsys, budget, skipped):
    calls = []
    monkeypatch.setattr(bench, "_run_section", _fake_sections(calls))
    monkeypatch.setattr(bench, "TOTAL_BUDGET", budget)
    monkeypatch.delenv("BENCH_TRAIN_MODES", raising=False)
    bench.orchestrate(["16"], "cpu")
    line = _last_line(capsys)
    assert [s for s in skipped if s in line["error"]] == skipped
    names = [a[a.index("--section") + 1] for a, _ in calls]
    assert names == ["probe"] + (["infer"] if budget == 300 else [])
    assert line["value"] is None and line["vs_baseline"] is None


def test_a_probe_without_a_card_stops_the_bench(monkeypatch, capsys):
    calls = []

    def run(args, timeout):
        calls.append(args)
        return {"ok": False, "backend": None, "error": "no CUDA device is available"}, None

    monkeypatch.setattr(bench, "_run_section", run)
    bench.orchestrate(["16"], "cuda")
    line = _last_line(capsys)
    assert len(calls) == 1 and "no CUDA device" in line["error"]
    assert "device probe never succeeded (1 attempts" in line["error"]


def _bench_process(*args, env=None):
    return subprocess.Popen([sys.executable, "-m", "yolo_continuous_tpu_torch.bench", *args],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, **(env or {})))


def test_sigterm_prints_the_line_and_exits_0():
    proc = _bench_process("2", "--device", "cpu")
    try:
        first = json.loads(proc.stdout.readline())     # the line after the probe
        assert first["value"] is None and first["device"] == {"backend": "cpu"}
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-2000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["error"].startswith("killed by signal 15")


def test_no_card_records_the_probe_error_and_runs_no_section():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = _bench_process("--device", "cuda", env={"BENCH_TRAIN_MODES": "base,bn_remat"})
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-2000:]
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert "device probe never succeeded" in line["error"] and "no CUDA device" in line["error"]
    assert line["value"] is None and "infer_img_s" not in line and "train_sweep" not in line
    assert "--section" not in err.replace("'--section', 'probe'", "")   # only the probe ran
