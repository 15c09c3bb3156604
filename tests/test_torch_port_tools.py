"""PyTorch port vs JAX package: the tools and utilities
(``tools/gen_anchors.py``, ``tools/gen_annotation.py``,
``tools/torch_import.py``, ``tools/torch_export.py``, ``utils/image.py``,
``utils/env.py``).

- anchors, index and annotation files: equal to JAX's from the same seed;
- ``torch_export`` of the port's ``.train.pt``: JAX's ``export_checkpoint``
  of the same weights as a ``.msgpack``, tensor for tensor, plus the
  ``num_batches_tracked`` entries a torch BatchNorm has;
- a JAX-exported ``.pth`` in the reference's layout (a depthwise row without
  the port's wrapper segment, no ``num_batches_tracked``) loads through
  ``load_torch_checkpoint`` and gives JAX's maps within 1e-5 (fp32, eval),
  and the ``Detector`` serves it; a bare Backbone checkpoint loads through
  the body route with JAX's maps within 1e-5, a YoloBody one into YoloBody;
- ``utils/image`` exact, ``utils/env`` strings equal.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_port as TP
from test_tools import _write_voc
from yolo_continuous_tpu_torch.config.plan import TrainPlan

S = 64
ATOL = 1e-5
# a shallow net with a depthwise row: the reference builds dw_conv as a bare
# Conv (model.1.conv.weight), the JAX package and the port wrap it
# (model.1.conv.conv.weight)
DW_NET = {"depth_multiple": 1.0, "width_multiple": 1.0,
          "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "DWConv", [16, 3, 2]],
                       [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                       [-1, 1, "Conv", [64, 3, 2]]],
          "head": [[[2, 3, 4], 1, "Detect", ["nc", "anchors"]]]}


def _plan_cfg(tmp_path, net=DW_NET):
    return dict(TP.tiny_plan_cfg("Detect", S), model_cfg=net, save_dir=str(tmp_path) + "/",
                save_name="exp")


def test_gen_anchors_matches_jax(tmp_path):
    from yolo_continuous_tpu.tools import gen_anchors as J
    from yolo_continuous_tpu_torch.tools import gen_anchors as P
    _write_voc(tmp_path, n=16, seed=1)
    ann = str(tmp_path / "VOCX" / "Annotations")
    want = J.gen_anchors(ann, (640, 640), 6, str(tmp_path / "j.txt"), seed=3)
    got = P.gen_anchors(ann, (640, 640), 6, str(tmp_path / "p.txt"), seed=3)
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()
    data = np.random.RandomState(0).rand(40, 2)
    for a, b in zip(P.kmeans(data, 3, seed=5), J.kmeans(data, 3, seed=5)):
        np.testing.assert_array_equal(a, b)
    assert P.avg_ratio(data, want / 640) == J.avg_ratio(data, want / 640)


def test_gen_annotation_matches_jax(tmp_path):
    from yolo_continuous_tpu.tools.gen_annotation import prepare_voc as jax_prepare
    from yolo_continuous_tpu_torch.tools.gen_annotation import prepare_voc
    roots = {}
    for name in ("jax", "port"):
        roots[name] = tmp_path / name
        roots[name].mkdir()
        _write_voc(roots[name], n=14, seed=2)
    want = jax_prepare(str(roots["jax"]), ["VOCX"], ["cat", "dog"], seed=4)
    got = prepare_voc(str(roots["port"]), ["VOCX"], ["cat", "dog"], seed=4)
    assert got == want
    for rel in ("train.txt", "val.txt", "test.txt", "trainval.txt", "VOCX/train.txt",
                "VOCX/val.txt", "VOCX/test.txt", "VOCX/trainval.txt"):
        a = (roots["port"] / rel).read_text().replace(str(roots["port"]), "ROOT")
        b = (roots["jax"] / rel).read_text().replace(str(roots["jax"]), "ROOT")
        assert a == b, rel


def _jax_state(plan_cfg):
    """A JAX train state of the plan with ``lively`` weights and statistics."""
    from yolo_continuous_tpu.config.plan import TrainPlan as JPlan
    from yolo_continuous_tpu.train.ema import ema_init
    from yolo_continuous_tpu.train.train_loop import Trainer as JTrainer
    tr = JTrainer(JPlan(plan_cfg), dtype=jnp.float32)
    state = tr.init_state(jax.random.PRNGKey(0))
    rs = np.random.RandomState(7)
    params, stats = TP.lively(state["params"], rs), TP.lively(state["batch_stats"], rs)
    state = dict(state, params=params, batch_stats=stats,
                 ema=ema_init({"params": params, "batch_stats": stats}))
    return tr, state


def test_torch_export_matches_jax_export(tmp_path):
    from yolo_continuous_tpu.tools.torch_export import export_checkpoint as jax_export
    from yolo_continuous_tpu.train.checkpoint import save_checkpoint as jax_save
    from yolo_continuous_tpu_torch.tools.jax_weights import state_dict_from_jax
    from yolo_continuous_tpu_torch.tools.torch_export import export_checkpoint, main
    from yolo_continuous_tpu_torch.train.checkpoint import save_checkpoint, train_checkpoint_path
    from yolo_continuous_tpu_torch.train.train_loop import Trainer
    cfg = _plan_cfg(tmp_path)
    jtr, jstate = _jax_state(cfg)
    plan = TrainPlan(cfg)
    with pytest.raises(FileNotFoundError):
        export_checkpoint(plan, str(tmp_path / "none.pth"))      # no checkpoint yet
    jax_save(plan.save_path, jstate)
    jax_export(plan, str(tmp_path / "jax.pth"))
    want = torch.load(tmp_path / "jax.pth", weights_only=True)
    tr = Trainer(plan, device="cpu")
    state = tr.init_state(state_dict=state_dict_from_jax(tr.spec, jstate["params"],
                                                         jstate["batch_stats"]))
    save_checkpoint(train_checkpoint_path(plan.save_path), state)
    _same_export(export_checkpoint(plan, str(tmp_path / "from_train_pt.pth")), want)
    raw = export_checkpoint(plan, str(tmp_path / "raw.pth"), use_ema=False)
    _same_export(raw, want)                       # a fresh EMA is the weights
    import yaml
    with open(tmp_path / "plan.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    main([str(tmp_path / "plan.yaml"), str(tmp_path / "cli.pth")])
    _same_export(torch.load(tmp_path / "cli.pth", weights_only=True), want)


@pytest.mark.parametrize("raw", [False, True])
def test_torch_export_of_a_jax_checkpoint_matches_jax_export(tmp_path, raw):
    """With no ``.train.pt``, the port exports the JAX ``.msgpack`` at
    ``save_path``: its EMA weights (another tree than the raw ones here), or
    the raw ones with ``--raw``, as JAX's ``export_checkpoint`` does."""
    import yaml
    from yolo_continuous_tpu.tools.torch_export import export_checkpoint as jax_export
    from yolo_continuous_tpu.train.checkpoint import save_checkpoint as jax_save
    from yolo_continuous_tpu.train.ema import ema_init
    from yolo_continuous_tpu_torch.tools.torch_export import export_checkpoint, main
    cfg = _plan_cfg(tmp_path)
    _, jstate = _jax_state(cfg)
    rs = np.random.RandomState(11)
    jstate["ema"] = ema_init({"params": TP.lively(jstate["params"], rs),
                              "batch_stats": TP.lively(jstate["batch_stats"], rs)})
    plan = TrainPlan(cfg)
    jax_save(plan.save_path, jstate)
    jax_export(plan, str(tmp_path / "jax.pth"), use_ema=not raw)
    want = torch.load(tmp_path / "jax.pth", weights_only=True)
    _same_export(export_checkpoint(plan, str(tmp_path / "port.pth"), use_ema=not raw), want)
    with open(tmp_path / "plan.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    main([str(tmp_path / "plan.yaml"), str(tmp_path / "cli.pth")] + (["--raw"] if raw else []))
    _same_export(torch.load(tmp_path / "cli.pth", weights_only=True), want)
    jax_export(plan, str(tmp_path / "other.pth"), use_ema=raw)
    other = torch.load(tmp_path / "other.pth", weights_only=True)
    assert any(not torch.equal(other[k], v) for k, v in want.items())   # EMA is not raw


def _same_export(got, want):
    extra = set(got) - set(want)
    assert set(want) <= set(got) and all(k.endswith("num_batches_tracked") for k in extra)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def _reference_layout(sd):
    """The JAX export as the reference names it: the depthwise row without
    its wrapper segment, no ``num_batches_tracked``."""
    return {k.replace("model.1.conv.conv.", "model.1.conv.").replace("model.1.conv.bn.",
                                                                      "model.1.bn."): v
            for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def test_reference_pth_loads_through_the_importer(tmp_path):
    from yolo_continuous_tpu.tools.torch_import import export_state_dict
    from yolo_continuous_tpu_torch.detect_api import Detector
    from yolo_continuous_tpu_torch.nn.builder import YoloModel
    from yolo_continuous_tpu_torch.tools.torch_import import (convert_state_dict,
                                                              load_torch_checkpoint)
    cfg = _plan_cfg(tmp_path)
    jtr, jstate = _jax_state(cfg)
    sd = _reference_layout(export_state_dict(jtr.spec, jstate["params"], jstate["batch_stats"]))
    assert "model.1.conv.weight" in sd and "model.1.bn.running_var" in sd
    pth = tmp_path / "exp.pth"                    # beside the plan's save_path
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, pth)
    plan = TrainPlan(cfg)
    model = YoloModel(_port_spec(plan))
    model.load_state_dict(load_torch_checkpoint(str(pth), model.spec), strict=True)
    x = np.random.RandomState(8).rand(2, S, S, 3).astype(np.float32)
    want = jtr.model.apply({"params": jstate["params"], "batch_stats": jstate["batch_stats"]},
                           jnp.asarray(x), False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    with pytest.raises(KeyError, match="unconsumed"):
        convert_state_dict(dict(sd, extra=torch.zeros(1)), model.spec)
    with pytest.raises(KeyError, match="no torch key"):
        convert_state_dict({k: v for k, v in sd.items() if "model.0." not in k}, model.spec)
    kept = convert_state_dict({k: v for k, v in sd.items() if "model.0." not in k}, model.spec,
                              strict=False)
    assert set(kept) == set(model.state_dict())
    det = Detector(plan, device="cpu")            # serves the .pth beside save_path
    for k, v in model.state_dict().items():
        assert torch.equal(det.model.state_dict()[k], v), k


def _port_spec(plan):
    from yolo_continuous_tpu_torch.config.plan import cvt_cfg
    from yolo_continuous_tpu_torch.nn.builder import build_model_spec
    return build_model_spec(cvt_cfg(plan.model_cfg), plan.image_chan, plan.anchors,
                            plan.num_labels, plan.anchors_mask)


def test_body_checkpoints_load_through_the_body_route(tmp_path):
    from yolo_continuous_tpu.nn import yolo_body as jax_body
    from yolo_continuous_tpu_torch.nn import yolo_body
    from yolo_continuous_tpu_torch.tools.jax_weights import body_state_dict_from_jax
    from yolo_continuous_tpu_torch.tools.torch_import import load_torch_body_checkpoint
    jm = jax_body.Backbone(8, 8, 4, "l")
    x = np.random.RandomState(9).rand(2, S, S, 3).astype(np.float32)
    v = jax.eval_shape(lambda k, a: jm.init(k, a, False), jax.random.PRNGKey(0),
                       jnp.asarray(x[:1]))
    rs = np.random.RandomState(10)
    params, stats = TP.lively(v["params"], rs), TP.lively(v["batch_stats"], rs)
    sd = {k: t for k, t in body_state_dict_from_jax(params, stats).items()
          if not k.endswith("num_batches_tracked")}       # a bare pretrained-backbone file
    assert any(k.startswith("stem.0.") for k in sd)
    torch.save(sd, tmp_path / "backbone.pth")
    model = yolo_body.Backbone(8, 8, 4, "l").eval()
    model.load_state_dict(load_torch_body_checkpoint(str(tmp_path / "backbone.pth"), model),
                          strict=True)
    want = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), False)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)
    body = yolo_body.YoloBody(2, "l")
    full = {k: torch.randn_like(t) if t.is_floating_point() else t
            for k, t in body.state_dict().items()}
    torch.save(full, tmp_path / "body.pth")
    got = load_torch_body_checkpoint(str(tmp_path / "body.pth"), body)
    assert all(torch.equal(got[k], t) for k, t in full.items())


def test_utils_image_and_env_match_jax(tmp_path):
    from yolo_continuous_tpu.utils import env as JENV
    from yolo_continuous_tpu.utils import image as JIMG
    from yolo_continuous_tpu_torch.utils import env, image
    rs = np.random.RandomState(11)
    img = rs.randint(0, 255, (37, 53, 3), np.uint8)
    for fn in ("hwc_to_chw",):
        np.testing.assert_array_equal(getattr(image, fn)(img), getattr(JIMG, fn)(img))
    chw = JIMG.hwc_to_chw(img)
    np.testing.assert_array_equal(image.chw_to_hwc(chw), JIMG.chw_to_hwc(chw))
    np.testing.assert_array_equal(image.resize_by_largeborder(img, 64),
                                  JIMG.resize_by_largeborder(img, 64))
    for shape in ((64, 64), (40, 90)):
        np.testing.assert_array_equal(image.resize_and_padding(img, shape),
                                      JIMG.resize_and_padding(img, shape))
        np.testing.assert_array_equal(image.resize_and_padding(img[..., 0], shape),
                                      JIMG.resize_and_padding(img[..., 0], shape))
    here = os.path.dirname(os.path.abspath(__file__))
    assert env.date_modified(__file__) == JENV.date_modified(__file__)
    assert env.git_describe(here) == JENV.git_describe(here)
    assert env.git_describe(str(tmp_path)) == JENV.git_describe(str(tmp_path))
