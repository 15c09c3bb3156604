"""Shared inputs of the PyTorch-port parity tests (tests/test_torch_port_*.py).

Weights are the JAX package's own trees, redrawn with numpy from a seed at
a scale that keeps activations O(1) through the depth, so head maps depend
on the input and detection scores are spread (the stock 0.02-std init
gives near-constant maps and exactly tied scores).
"""
import numpy as np

ANCHORS = [[12, 16, 19, 36, 40, 28], [36, 75, 76, 55, 72, 146],
           [142, 110, 192, 243, 459, 401]]

# (C_in, C_out, H, W) of the 24 fused-tail Convs of cfg/net/yolov7.yaml at
# 640 px, in call order: the shapes that kernel K5 takes on the main path
YOLOV7_640_FUSED_TAILS = [
    (512, 512, 80, 80), (512, 256, 40, 40), (512, 256, 80, 80), (512, 256, 40, 40),
    (512, 256, 40, 40), (1024, 1024, 40, 40), (1024, 512, 20, 20), (1024, 512, 40, 40),
    (1024, 256, 20, 20), (1024, 256, 20, 20), (1024, 1024, 20, 20), (512, 256, 20, 20),
    (1024, 256, 40, 40), (512, 256, 40, 40), (512, 256, 40, 40), (1024, 256, 40, 40),
    (512, 128, 80, 80), (512, 128, 80, 80), (512, 256, 40, 40), (512, 256, 40, 40),
    (1024, 256, 40, 40), (1024, 512, 20, 20), (1024, 512, 20, 20), (2048, 512, 20, 20)]


def lively(tree, rs: np.random.RandomState, parent: str = ""):
    """Redraw every leaf of a JAX params / batch_stats tree (nested dicts).

    ``implicit`` leaves: ImplicitA (``ia*`` or an ``ImplicitA`` row) ~ 0.1
    randn, ImplicitM (``im*`` or an ``ImplicitM`` row) ~ 1 + 0.1 randn;
    RobustConv's layer scale ``gamma`` ~ 1 + 0.1 randn (its 1e-6 init would
    hide the block)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if hasattr(v, "items"):
            out[k] = lively(v, rs, k)
            continue
        shape = np.shape(v)
        if k == "kernel":        # HWIO: fan-in is every axis but the last
            out[k] = rs.randn(*shape) * np.sqrt(1.0 / np.prod(shape[:-1]))
        elif k == "scale":
            out[k] = 1.0 + 0.1 * rs.randn(*shape)
        elif k in ("bias", "mean"):
            out[k] = 0.1 * rs.randn(*shape)
        elif k == "var":
            out[k] = rs.rand(*shape) + 0.5
        elif k == "implicit" and parent.startswith(("ia", "im")):
            out[k] = (1.0 if parent.startswith("im") else 0.0) + 0.1 * rs.randn(*shape)
        elif k == "implicit" and parent.endswith(("_ImplicitA", "_ImplicitM")):
            out[k] = (1.0 if parent.endswith("M") else 0.0) + 0.1 * rs.randn(*shape)
        elif k == "gamma":
            out[k] = 1.0 + 0.1 * rs.randn(*shape)
        else:
            raise KeyError(f"unexpected leaf {k!r}")
        out[k] = out[k].astype(np.float32)
    return out


# tests/test_zoo_coverage.py's SINGLE_INPUT_BLOCKS, without that file's JAX
# import (the card's machine has no flax); tests/test_torch_port_zoo_a.py
# holds the two equal
ZOO_BLOCKS = [
    ("Conv", [16, 3, 1]), ("Conv", [16, 3, 1, None, 1, "nn.LeakyReLU(0.1)"]),
    ("nn.Conv2d", [16, 3, 1]), ("dw_conv", [16, 3, 1]), ("GhostConv", [16, 3, 1]),
    ("RobustConv", [16, 7, 1]), ("RobustConv2", [16, 7, 2]), ("RepConv", [16, 3, 1]),
    ("DownC", [16]), ("SPP", [16]), ("SPPF", [16]), ("SPPCSPC", [16]), ("GhostSPPCSPC", [16]),
    ("Focus", [16, 3]), ("Stem", [16]), ("GhostStem", [16]), ("Bottleneck", [16]),
    ("BottleneckCSPA", [16]), ("BottleneckCSPB", [16]), ("BottleneckCSPC", [16]),
    ("RepBottleneck", [16]), ("RepBottleneckCSPA", [16]), ("RepBottleneckCSPB", [16]),
    ("RepBottleneckCSPC", [16]), ("Res", [16]), ("ResCSPA", [16]), ("ResCSPB", [16]),
    ("ResCSPC", [16]), ("RepRes", [16]), ("RepResCSPA", [16]), ("RepResCSPB", [16]),
    ("RepResCSPC", [16]), ("ResX", [64, True, 8]), ("ResXCSPA", [64, True, 8]),
    ("ResXCSPB", [64, True, 8]), ("ResXCSPC", [64, True, 8]), ("RepResX", [64, True, 8]),
    ("RepResXCSPA", [64, True, 8]), ("RepResXCSPB", [64, True, 8]),
    ("RepResXCSPC", [64, True, 8]), ("Ghost", [16]), ("GhostCSPA", [16]), ("GhostCSPB", [16]),
    ("GhostCSPC", [16]), ("MP", []), ("SP", [3]), ("ReOrg", []), ("Foldcut", []),
    ("Contract", [2]), ("Expand", [2]), ("nn.BatchNorm2d", []),
]

# The zoo's rows chained into one net a group (a block takes the block before
# it), so that a few compiles cover them all: (input size, ZOO_BLOCKS
# indices, extra rows). The spatial size stays at least 8 at the head.
ZOO_GROUPS = {
    # 16 -> 16 at /2; the Conv rows also with every activation the YAML parser gives
    "conv": (64, range(0, 8), [["Conv", [16, 3, 1, None, 1, "nn.ReLU()"]],
                               ["Conv", [16, 1, 1, None, 1, "nn.Hardswish()"]],
                               ["Conv", [16, 3, 1, None, 1, "nn.Identity()"]],
                               ["Conv", [16, 1, 1, None, 1, "nn.SiLU()"]]]),
    "spp": (64, range(8, 13), []),             # DownC (/2), then the SPP family
    "stems": (512, range(13, 16), []),         # Focus (/2), Stem and GhostStem (/4 each)
    "bottleneck": (64, range(16, 24), []),
    "res": (64, range(24, 32), []),
    "resx": (64, range(32, 40), []),
    # Ghost family, MP (/2), SP, nn.BatchNorm2d; the implicit rows and a transformer
    "ghost": (64, list(range(40, 46)) + [50], [["ImplicitA", []], ["ImplicitM", []],
                                                 ["TransformerBlock", [16, 16, 4, 2]]]),
    "reshape": (64, range(46, 50), []),        # ReOrg (/2), Foldcut, Contract (/2), Expand (x2)
}
# tests/test_zoo_coverage.py's multi-input and repeat nets (no stem added)
ZOO_NETS = {
    "multi_input": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 1]],
                    [[-1, -2], 1, "Concat", [1]], [[-1, -2], 1, "Chuncat", [1]],
                    [-1, 1, "Conv", [16, 1, 1]], [[-1, 1], 1, "Shortcut", [0]]],
    "repeat": [[-1, 1, "Conv", [16, 3, 2]], [-1, 2, "Bottleneck", [16]],
               [-1, 2, "BottleneckCSPA", [16]]],
}


def zoo_net(group: str):
    """(net dict, input size) of a ZOO_GROUPS group or a ZOO_NETS net."""
    if group in ZOO_NETS:
        return single_block_net(ZOO_NETS[group], stem=False), 64
    size, idx, extra = ZOO_GROUPS[group]
    rows = [[-1, 1, n, list(a)] for n, a in [ZOO_BLOCKS[i] for i in idx] + extra]
    return single_block_net(rows), size


# a small net of RepConv rows: an identity branch, a strided one, a repeated
# one; the Detect head reads layers 4, 6, 7 (strides 8, 16, 32)
FUSE_NET = {"depth_multiple": 1.0, "width_multiple": 1.0,
            "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "RepConv", [16, 3, 1]],
                         [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "RepConv", [32, 3, 2]],
                         [-1, 2, "RepConv", [32, 3, 1]], [-1, 1, "Conv", [64, 3, 2]],
                         [-1, 1, "RepConv", [64, 3, 1]], [-1, 1, "Conv", [64, 3, 2]]],
            "head": [[[4, 6, 7], 1, "Detect", ["nc", "anchors"]]]}


def spread_weights(model, seed: int):
    """Redraw a port model's floating state in place, from a CPU generator,
    at the scale ``lively`` gives JAX trees (no JAX here): weights of fan-in
    n ~ N(0, 1/n), BN scales ~ 1 + 0.1 N(0, 1), biases and means ~ 0.1 N(0, 1),
    variances U(0.5, 1.5), implicit priors and layer scales ~ 1 + 0.1 N(0, 1)."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if not t.is_floating_point():
                continue
            draw = torch.empty(t.shape)                 # on the CPU, whatever the model's device
            if name.endswith("running_var"):
                draw.uniform_(0.5, 1.5, generator=gen)
            elif name.endswith(("bias", "running_mean")):
                draw.normal_(0.0, 0.1, generator=gen)
            elif t.dim() >= 2 and name.endswith("weight"):
                draw.normal_(0.0, (1.0 / t[0].numel()) ** 0.5, generator=gen)
            else:                       # BN scales, implicit priors, layer scales
                draw.normal_(1.0, 0.1, generator=gen)
            t.copy_(draw)
    return model


def single_block_net(rows, stem: bool = True) -> dict:
    """``rows`` after a stem conv (16 channels, /2; unless ``not stem``) and
    before a 3-level Detect head (two more /2 convs), as
    tests/test_zoo_coverage.py builds its nets."""
    head = [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
            [[-3, -2, -1], 1, "Detect", ["nc", "anchors"]]]
    backbone = ([[-1, 1, "Conv", [16, 3, 2]]] if stem else []) + [list(r) for r in rows]
    return {"depth_multiple": 1.0, "width_multiple": 1.0, "backbone": backbone, "head": head}


def jax_and_port_maps(cfg: dict, size: int, nc: int = 2, batch: int = 2, seed: int = 0,
                      anchors=None, anchors_mask=None):
    """The raw head maps of the JAX ``YoloModel`` (eval, fp32, jitted) and of
    the port's, from the same ``lively`` weights and input. The JAX tree is
    taken by ``eval_shape`` (no init run). Returns (jax maps as numpy, port
    maps as numpy, the port model, (JAX spec, params, batch_stats))."""
    import jax
    import jax.numpy as jnp
    import torch
    from yolo_continuous_tpu.nn.builder import YoloModel as JaxModel
    from yolo_continuous_tpu.nn.builder import build_model_spec as jax_spec
    from yolo_continuous_tpu_torch.nn.builder import YoloModel, build_model_spec
    from yolo_continuous_tpu_torch.tools.jax_weights import state_dict_from_jax

    anchors = anchors or ANCHORS
    x = np.random.RandomState(seed).rand(batch, size, size, 3).astype(np.float32)
    jm = JaxModel(spec=jax_spec(cfg, 3, anchors, nc, anchors_mask))
    shapes = jax.eval_shape(lambda k, a: jm.init(k, a, False), jax.random.PRNGKey(0),
                            jnp.asarray(x[:1]))
    rs = np.random.RandomState(seed + 1)
    params, stats = lively(shapes["params"], rs), lively(shapes.get("batch_stats", {}), rs)
    ref = jax.jit(jm.apply, static_argnums=2)({"params": params, "batch_stats": stats},
                                               jnp.asarray(x), False)
    model = YoloModel(build_model_spec(cfg, 3, anchors, nc, anchors_mask)).eval()
    model.load_state_dict(state_dict_from_jax(model.spec, params, stats), strict=True)
    with torch.no_grad():
        ours = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    return [np.asarray(r) for r in ref], [o.numpy() for o in ours], model, (jm.spec, params, stats)


def assert_state_dict_equals_export(jax_tree, port_spec, attention: bool = False):
    """``state_dict_from_jax`` gives JAX ``export_state_dict``'s keys and
    values (and ``num_batches_tracked``), but for the attention, which export
    has no rule for; ``attention`` says whether the net has some."""
    from yolo_continuous_tpu.tools.torch_import import export_state_dict
    from yolo_continuous_tpu_torch.tools.jax_weights import state_dict_from_jax
    spec, params, stats = jax_tree
    ours = state_dict_from_jax(port_spec, params, stats)
    ref = {k: np.asarray(v) for k, v in export_state_dict(spec, params, stats).items()}
    exported = {k for k in ref if ".tr" in k}
    assert bool(exported) == attention
    plain = {k for k in ours if not k.endswith("num_batches_tracked") and ".tr." not in k}
    assert plain == set(ref) - exported
    for k in plain:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)


def min_score_gap(scores, k: int) -> float:
    """Smallest gap between neighbouring top-(k+1) scores of each row: the
    precondition that torch.topk and lax.top_k rank the same candidates."""
    s = -np.sort(-np.asarray(scores, np.float64), axis=-1)[..., : k + 1]
    return float(np.min(s[..., :-1] - s[..., 1:]))


def tiny_head_net(head: str) -> dict:
    """A minimal 3-level net ending in ``head`` (tests/test_head_variants.py)."""
    backbone = [[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                [-1, 1, "Conv", [64, 3, 2]]]              # P3 = 2, P4 = 3, P5 = 4
    if head == "IAuxDetect":
        hd = [[2, 1, "Conv", [16, 1, 1]], [3, 1, "Conv", [32, 1, 1]],
              [4, 1, "Conv", [64, 1, 1]], [[2, 3, 4, 5, 6, 7], 1, "IAuxDetect", ["nc", "anchors"]]]
    else:
        hd = [[[2, 3, 4], 1, head, ["nc", "anchors"]]]
    return {"depth_multiple": 1.0, "width_multiple": 1.0, "backbone": backbone, "head": hd}


def tiny_plan_cfg(head: str, size: int) -> dict:
    """A plan dict for ``tiny_head_net(head)``: 2 classes, no checkpoint."""
    return {"device": "cpu", "train": "x", "val": "x", "epochs": 1, "batch_size": 2,
            "image_size": size, "image_chan": 3, "enhance": False, "shuffle": False,
            "pin_memory": False, "drop_last": True, "workers": 0, "labels": ["a", "b"],
            "enhance_cfg": "cfg/enhance/enhance.yaml", "model_cfg": tiny_head_net(head),
            "anchors": ANCHORS, "anchors_mask": [[6, 7, 8], [3, 4, 5], [0, 1, 2]],
            "adam": False, "decay": "Linear", "lrI": 0.01, "lrF": 0.01, "momentum": 0.9,
            "weight_decay": 5e-4, "warmup": False, "warmup_epochs": 1, "warmup_max_iter": 10,
            "warmup_momentum": 0.8, "warmup_bias_lr": 0.1, "focal_gamma": 1.5,
            "focal_alpha": 0.25, "resume": False, "save_dir": "/nonexistent/",
            "save_name": head.lower(), "max_boxes": 8}


def ibin_logits(rs: np.random.RandomState, lead, nc: int, bin_count: int = 21):
    """Raw IBin maps ``lead + (nc + 3 + 2 (bins + 1),)`` whose top two bins of
    every value are a logit apart (one random bin raised above the rest)."""
    n = bin_count + 1
    p = (rs.randn(*lead, nc + 3 + 2 * n) * 2.0).astype(np.float32)
    for off in (3, 3 + n):
        bins = np.clip(p[..., off:off + bin_count], -3.0, 3.0)
        win = rs.randint(0, bin_count, lead)[..., None]
        np.put_along_axis(bins, win, bins.max(-1, keepdims=True) + 1.0, -1)
        p[..., off:off + bin_count] = bins
    return p


def min_bin_gap(raw, bin_count: int = 21) -> float:
    """Smallest gap between the top two sigmoided bins of any w/h value of raw
    IBin maps: the precondition that every argmax picks the same bin whatever
    ulps exp() is off by."""
    n = bin_count + 1
    s = 1.0 / (1.0 + np.exp(-np.asarray(raw, np.float64)))
    gaps = []
    for off in (3, 3 + n):
        top2 = -np.sort(-s[..., off:off + bin_count], axis=-1)[..., :2]
        gaps.append(np.min(top2[..., 0] - top2[..., 1]))
    return float(min(gaps))


def jax_batch_draw(key, cfg, B: int, T: int, max_boxes: int, mosaic, mixup):
    """The parameters that JAX's ``augment_batch(key, ...)`` draws, with the
    batch's flags ``mosaic`` and ``mixup``, as the port's ``BatchDraw`` (CPU
    tensors): JAX's key splits replayed in JAX
    (``ops/augment.py:224-231`` single, ``:274-284`` mosaic, ``:355`` and
    ``enhance.py:118-121`` post-enhance with the perspective of
    ``enhance.py:148-178`` when ``cfg.use_perspective``, ``:425-428`` per
    sample, ``:474`` copy-paste). Feeding these to the port's apply step must give JAX's
    outputs."""
    import jax
    import torch
    from yolo_continuous_tpu_torch.ops.augment import (BatchDraw, MosaicDraw, SingleDraw,
                                                       paste_boxes, perspective_cfg)
    from yolo_continuous_tpu_torch.ops.enhance import EnhanceDraw, perspective_from_uniforms

    def u(k, lo, hi, shape=()):
        return np.asarray(jax.random.uniform(k, shape, np.float32, lo, hi))

    def jitter(k, lo, hi):
        k1, k2, k3 = jax.random.split(k, 3)
        j = cfg.jitter
        return [u(k1, 1 - j, 1 + j), u(k2, 1 - j, 1 + j)], u(k3, lo, hi)

    def enhance(k):
        kp, kf, ke = jax.random.split(k, 3)
        k1, k2 = jax.random.split(kf)
        flags = [float(jax.random.uniform(k1)) < 0.0, float(jax.random.uniform(k2)) < cfg.flip_ud,
                 float(jax.random.uniform(ke)) < cfg.equalize]
        return flags, perspective_uniforms(jax.random.split(kp)[0], perspective_cfg(cfg))

    rec = {n: [] for n in ("ar", "scale", "dxy", "flip", "hsv", "partner", "post",
                           "m_off", "m_ar", "m_scale", "m_flip", "m_hsv")}
    for k in jax.random.split(key, B):
        k1, k2, kx, kxp = jax.random.split(k, 4)
        kg, kp, kf, kh = jax.random.split(k2, 4)
        ar, scale = jitter(kg, cfg.scale_min, cfg.scale_max)
        kdx, kdy = jax.random.split(kp)
        rec["ar"].append(ar)
        rec["scale"].append(scale)
        rec["dxy"].append([u(kdx, 0.0, 1.0), u(kdy, 0.0, 1.0)])
        rec["flip"].append(bool(jax.random.bernoulli(kf, cfg.flip_lr)))
        rec["hsv"].append(u(kh, -1.0, 1.0, (3,)))
        rec["partner"].append(enhance(kxp))
        rec["post"].append(enhance(kx))
        kcx, kcy, kmh, *tkeys = jax.random.split(k1, 7)
        rec["m_off"].append([u(kcx, cfg.min_offset_lo, cfg.min_offset_hi),
                             u(kcy, cfg.min_offset_lo, cfg.min_offset_hi)])
        quads = []
        for q in range(4):
            kqg, kqf = jax.random.split(tkeys[q])
            quads.append(jitter(kqg, cfg.mosaic_scale_min, cfg.mosaic_scale_max)
                         + (bool(jax.random.bernoulli(kqf, cfg.flip_lr)),))
        rec["m_ar"].append([a for a, _, _ in quads])
        rec["m_scale"].append([s for _, s, _ in quads])
        rec["m_flip"].append([f for _, _, f in quads])
        rec["m_hsv"].append(u(kmh, -1.0, 1.0, (3,)))
    paste = jax.random.bernoulli(jax.random.fold_in(key, 0x5e1f), cfg.copy_paste,
                                 (B, paste_boxes(T, max_boxes)))

    def t(name, dtype=np.float32):
        return torch.from_numpy(np.asarray(rec[name], dtype))

    def e(name):
        flags = torch.from_numpy(np.asarray([f for f, _ in rec[name]], bool)).T
        persp = None
        if cfg.use_perspective:
            values = torch.from_numpy(np.asarray([v for _, v in rec[name]], np.float32))
            persp = perspective_from_uniforms(values, cfg.size, cfg.size)
        return EnhanceDraw(*flags, persp)

    m_draw = MosaicDraw(t("m_off"), t("m_ar"), t("m_scale"), t("m_flip", bool), t("m_hsv"))
    return BatchDraw.of(single=SingleDraw(t("ar"), t("scale"), t("dxy"), t("flip", bool),
                                          t("hsv")),
                        partner=e("partner"), mosaic=m_draw if T == 4 else None, post=e("post"),
                        paste=torch.from_numpy(np.array(paste)), mosaic_flag=mosaic,
                        mixup_flag=mixup)


def perspective_uniforms(key, cfg) -> list:
    """The 8 uniforms JAX's ``_perspective_matrix(key, ...)`` draws
    (``enhance.py:148-178``: ``split(key, 8)``, one value a key), for the
    port's ``enhance.perspective_from_uniforms``."""
    import jax
    from yolo_continuous_tpu_torch.ops.enhance import perspective_ranges
    return [float(jax.random.uniform(k, (), np.float32, lo, hi))
            for k, (lo, hi) in zip(jax.random.split(key, 8), perspective_ranges(cfg))]


def write_dataset(root, n: int, seed: int = 0, shapes=((48, 64), (64, 48), (64, 64), (40, 72)),
                  max_boxes: int = 6, n_classes: int = 2, square: bool = False) -> str:
    """``n`` JPEGs written with cv2 under ``root`` (a pathlib.Path), mixed
    aspect ratios (``shapes``, cycled; 64 x 64 each with ``square``), 0 to
    ``max_boxes`` boxes each, plus the annotation file. Returns its path."""
    import cv2
    rs = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        h, w = (64, 64) if square else shapes[i % len(shapes)]
        img = rs.randint(0, 255, (h, w, 3), np.uint8)
        img[h // 4: h // 2, w // 4: w // 2] = rs.randint(0, 255, 3)   # a flat patch
        path = str(root / f"im{i}.jpg")
        cv2.imwrite(path, img)
        boxes = []
        for _ in range(rs.randint(0, max_boxes + 1)):
            bw, bh = rs.randint(6, w // 2), rs.randint(6, h // 2)
            x, y = rs.randint(0, w - bw), rs.randint(0, h - bh)
            boxes.append(f"{x},{y},{x + bw},{y + bh},{rs.randint(n_classes)}")
        lines.append(" ".join([path] + boxes) + "\n")
    ann = root / "train.txt"
    ann.write_text("".join(lines))
    return str(ann)


# A shallow IDetect net for the multi-process tests: every row's kernel is
# at least 16 channels wide, so that min_channels 16 shards them over
# "model" (a depthwise conv, RepConv branches, the head's ImplicitA), and
# the head's 21-channel LogitConvs and ImplicitMs stay replicated.
SHARD_NET = {"depth_multiple": 1.0, "width_multiple": 1.0,
             "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                          [-1, 1, "DWConv", [32, 3, 1]], [-1, 1, "Conv", [32, 3, 2]],
                          [-1, 1, "RepConv", [64, 3, 2]], [-1, 1, "Conv", [64, 3, 2]]],
             "head": [[[3, 4, 5], 1, "IDetect", ["nc", "anchors"]]]}
SHARD_MIN_CHANNELS = 16


def dist_plan_cfg(case: str, global_bs: int, size: int = 64, max_gt: int = 8) -> dict:
    """The plan of a multi-process test: the shallow net (``"shallow"``), or
    ``cfg/raccoon_tiny.yaml`` (yolov7-tiny, Adam) as the JAX package's
    ``tests/_dist_worker.py`` sizes it (``"raccoon"``)."""
    if case == "raccoon":
        import os
        from yolo_continuous_tpu_torch.config.plan import cvt_cfg
        here = os.path.dirname(os.path.abspath(__file__))
        cfg = dict(cvt_cfg(os.path.join(here, "..", "cfg", "raccoon_tiny.yaml")))
        cfg.update(image_size=size, max_boxes=max_gt, batch_size=global_bs)
        return cfg
    return dict(tiny_plan_cfg("IDetect", size), model_cfg=SHARD_NET, batch_size=global_bs,
                max_boxes=max_gt)


def dist_batch(global_bs: int, size: int = 64, max_gt: int = 8):
    """The global batch of the multi-process tests (``_dist_worker.py``'s):
    images from ``RandomState(0)``, one or two labels an image."""
    rs = np.random.RandomState(0)
    images = rs.rand(global_bs, size, size, 3).astype(np.float32)
    labels = np.zeros((global_bs, max_gt, 5), np.float32)
    labels[:, 0] = [0, 0.5, 0.5, 0.4, 0.4]
    labels[::2, 1] = [1, 0.3, 0.3, 0.2, 0.25]
    lmask = np.zeros((global_bs, max_gt), bool)
    lmask[:, 0] = True
    lmask[::2, 1] = True
    return images, labels, lmask


# (width, height) of the stager's test JPEGs: down- and up-scales at 64-128
# px, JAX's fp32 width case (133 x 65 at 640 gives nw = 639), 1 x 1
STAGING_SIZES = ((200, 100), (100, 200), (48, 64), (64, 48), (133, 65), (1, 1), (37, 91),
                 (128, 128))


def write_staging_files(root, seed: int = 0, sizes=STAGING_SIZES):
    """JPEGs of ``sizes`` (smooth content with noise and a flat patch), a
    grayscale JPEG, a PNG named ``.jpg`` (which libjpeg refuses) and the path
    of a missing file, under ``root`` (a pathlib.Path). Returns the paths."""
    import cv2
    rs = np.random.RandomState(seed)
    paths = []
    for k, (w, h) in enumerate(sizes):
        yy, xx = np.mgrid[0:h, 0:w]
        img = (rs.randint(40, 200, 3) + 40 * np.sin(xx / 7.0)[..., None]
               + 30 * np.cos(yy / 5.0)[..., None] + rs.randint(0, 30, (h, w, 3)))
        img = np.clip(img, 0, 255).astype(np.uint8)
        img[h // 4: h // 2, w // 4: w // 2] = rs.randint(0, 255, 3)
        paths.append(str(root / f"s{k}.jpg"))
        cv2.imwrite(paths[-1], img)
    gray = rs.randint(0, 255, (50, 70), np.uint8)
    paths.append(str(root / "gray.jpg"))
    cv2.imwrite(paths[-1], gray)
    cv2.imwrite(str(root / "png.png"), gray)
    (root / "png.png").rename(root / "png.jpg")
    paths += [str(root / "png.jpg"), str(root / "missing.jpg")]
    return paths


def jax_native_loader():
    """JAX's ``data/native_loader`` module with its C++ library built, or
    None where it does not build here. The build (``make -C native``) runs
    under a lock on the Makefile, so workers of one test run do not build it
    at once."""
    import fcntl
    import os
    from yolo_continuous_tpu.data import native_loader
    makefile = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "native", "Makefile")
    with open(makefile) as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            return native_loader if native_loader.available() else None
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
