"""Train-plan configuration loader (the PyTorch port's own copy).

Counterpart of ``yolo_continuous_tpu/config/plan.py``; the port keeps its
own copy so that it imports nothing of the JAX package. Attributes are the
same for every ``cfg/*.yaml`` (tests/test_torch_port_spec.py).

Parity target: ``cfg/train_plan.py:10-77`` in the reference — a flat YAML of
training knobs lifted into typed attributes. The shipped reference YAML files
(``cfg/voc_train.yaml`` etc.) parse unchanged through this class: every key
the reference reads is read here with the same meaning.

Deliberate fixes (flagged in SURVEY.md §2/§7):
- ``drop_last`` reads the ``drop_last`` key (the reference reads
  ``pin_memory`` by mistake, ``cfg/train_plan.py:29``).
- checkpoint path uses a ``.msgpack`` suffix (orbax/flax state, not torch).

PyYAML reads the plans where it is installed. Where it is not, ``cvt_cfg``
reads them with ``load_yaml_subset``, which covers the YAML that ``cfg/``
uses and gives the same dicts (tests/test_torch_port_spec.py).
"""
from __future__ import annotations

import glob
import os
import re
from pathlib import Path

try:
    import yaml
except ImportError:
    yaml = None


def check_file(file: str) -> str:
    """Resolve a file name to a path, searching recursively if needed.

    Mirrors ``utils/helper_io.py:7-14``.
    """
    if Path(file).is_file() or file == "":
        return file
    files = glob.glob("./**/" + file, recursive=True)
    assert len(files), f"File Not Found: {file}"
    assert len(files) == 1, f"Multiple files match '{file}', specify exact path: {files}"
    return files[0]


def cvt_cfg(cfg) -> dict:
    """YAML path or dict -> dict. Mirrors ``utils/helper_io.py:18-26``."""
    if isinstance(cfg, dict):
        return cfg
    with open(cfg) as f:
        text = f.read()
    return yaml.safe_load(text) if yaml is not None else load_yaml_subset(text)


_KEY = re.compile(r"([A-Za-z_][\w-]*):(?:\s+(.*))?$")
_ITEM = re.compile(r"\s*- (.*)$")
_TOKEN = re.compile(r"""\s*(\[|\]|,|"[^"]*"|'[^']*'|[^,\[\]]+)""")
# block scalars, anchors, tags, flow mappings, nested keys: not in the subset
_INDICATOR = re.compile(r"[|>&*!{}%@`]|.*:(\s|$)")
# YAML 1.1 scalars as PyYAML resolves them (decimal forms only)
_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?$")
_BOOL = {"true": True, "false": False, "yes": True, "no": False, "on": True, "off": False}


def _scalar(tok: str):
    if tok[:1] in ("'", '"'):
        return tok[1:-1]
    if tok in ("", "~", "null", "Null", "NULL"):
        return None
    if tok.lower() in _BOOL and tok in (tok.lower(), tok.capitalize(), tok.upper()):
        return _BOOL[tok.lower()]
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    return tok


def _flow(text: str):
    """One flow value: a scalar or a nested ``[a, "b", [c]]`` list."""
    tokens = [t.strip() for t in _TOKEN.findall(text) if t.strip()] + [None]
    bad = ValueError(f"not a one-line flow value: {text!r}")

    def parse(i):
        tok = tokens[i]
        if tok in (",", "]", None) or (tok[0] not in "'\"" and _INDICATOR.match(tok)):
            raise bad
        if tokens[i] != "[":
            return _scalar(tokens[i]), i + 1
        items, i = [], i + 1
        while tokens[i] != "]":
            item, i = parse(i)
            items.append(item)
            if tokens[i] not in (",", "]"):
                raise bad
            i += tokens[i] == ","
        return items, i + 1

    value, end = parse(0)
    if tokens[end] is not None:
        raise bad
    return value


def _strip_comment(line: str) -> str:
    quote = None
    for i, c in enumerate(line):
        if quote:
            quote = None if c == quote else quote
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i].rstrip()
    return line.rstrip()


def load_yaml_subset(text: str) -> dict:
    """``yaml.safe_load`` for the YAML that ``cfg/`` uses: one top-level
    mapping whose values are one-line flow values, or block sequences of
    them (``- [...]`` items). Raises ``ValueError`` on anything else."""
    out, block = {}, None
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw)
        if not line.strip():
            continue
        key, item = _KEY.match(line), _ITEM.match(line)
        if key:
            block = key.group(1) if key.group(2) is None else None
            out[key.group(1)] = None if block else _flow(key.group(2))
        elif item and block is not None:
            out[block] = (out[block] or []) + [_flow(item.group(1))]
        else:
            raise ValueError(f"line {n} is outside the YAML subset of cfg/: {raw!r}")
    return out


def _resolve_sibling(cfg_file: str, path: str) -> str:
    """Resolve cross-referenced cfg paths.

    The shipped reference plans embed absolute Windows paths
    (``cfg/voc_train.yaml:19-20``); when such a path does not exist we fall
    back to a file of the same basename next to this plan's cfg tree, so the
    reference YAMLs work unchanged on this machine.
    """
    if path is None or isinstance(path, dict):  # inline cfg dicts pass through
        return path
    p = str(path).replace("\\", "/")
    if os.path.exists(p):
        return p
    base = os.path.basename(p)
    cfg_dir = os.path.dirname(os.path.abspath(cfg_file)) if cfg_file else "."
    for cand in (
        os.path.join(cfg_dir, base),
        os.path.join(cfg_dir, "net", base),
        os.path.join(cfg_dir, "enhance", base),
        os.path.join(cfg_dir, "..", base),
    ):
        if os.path.exists(cand):
            return cand
    return p


class TrainPlan:
    """Flat YAML -> attributes; see ``cfg/train_plan.py:12-59``."""

    def __init__(self, cfg_file):
        if isinstance(cfg_file, dict):
            cfg, self._path = cfg_file, ""
        else:
            self._path = cfg_file
            cfg = cvt_cfg(cfg_file)
        self.cfg = cfg

        self.device = "{}".format(cfg.get("device", "tpu"))

        # dataset
        self.train_indexes = _resolve_sibling(self._path, cfg["train"])
        self.val_indexes = _resolve_sibling(self._path, cfg["val"])
        self.image_size = cfg["image_size"]
        self.image_chan = cfg["image_chan"]
        self.labels = cfg["labels"]
        self.num_labels = len(self.labels)
        self.epochs = cfg["epochs"]
        self.batch_size = cfg["batch_size"]
        self.shuffle = cfg["shuffle"]
        self.workers = cfg["workers"]
        self.pin_memory = cfg["pin_memory"]
        self.drop_last = cfg.get("drop_last", cfg["pin_memory"])

        self.enhance = cfg["enhance"]
        self.enhance_cfg = _resolve_sibling(self._path, cfg["enhance_cfg"])
        # The enhance YAML is loaded and CONSUMED by the train path
        # (ops/augment.aug_config_from_plan) — fixing the reference wart of
        # reading the path then ignoring it (main/data_loader.py:10-23).
        self.enhance_dict = {}
        if self.enhance and isinstance(self.enhance_cfg, dict):
            self.enhance_dict = self.enhance_cfg
        elif self.enhance and self.enhance_cfg and os.path.exists(str(self.enhance_cfg)):
            self.enhance_dict = cvt_cfg(self.enhance_cfg) or {}

        # model
        self.model_cfg = _resolve_sibling(self._path, cfg["model_cfg"])
        self.anchors = cfg["anchors"]
        self.anchors_mask = cfg["anchors_mask"]

        # optimizer
        self.adam = cfg["adam"]
        self.decay = cfg["decay"]
        self.learn_initial = cfg["lrI"]
        self.learn_final = cfg["lrF"]
        self.momentum = cfg["momentum"]
        self.weight_decay = cfg["weight_decay"]
        self.warmup = cfg["warmup"]
        self.warmup_epochs = cfg["warmup_epochs"]
        self.warmup_max_iter = cfg["warmup_max_iter"]
        self.warmup_momentum = cfg["warmup_momentum"]
        self.warmup_bias_lr = cfg["warmup_bias_lr"]
        self.focal_gamma = cfg["focal_gamma"]
        self.focal_alpha = cfg["focal_alpha"]

        # loss knobs. iou_loss_ratio is the reference's ``gr`` blend of the
        # obj target: tobj = (1-gr) + gr*iou (losses/yolo_loss.py:45,106 —
        # hard-coded 1 there; consumed for real here). The YAML's box/cls/obj
        # gain keys (cfg/voc_train.yaml:28-31) are NOT lifted to attributes:
        # the reference ignores them too (losses/yolo_loss.py:39-41 hard-codes
        # the ratios) and loss parity requires the same formulas.
        self.iou_loss_ratio = cfg.get("iou_loss_ratio", 1.0)
        self.anchor_t = cfg.get("anchor_t", 4.0)

        # TPU-specific extensions (absent from reference YAMLs -> defaults)
        self.max_boxes = cfg.get("max_boxes", 128)   # static GT capacity per image
        self.ema = cfg.get("ema", True)              # ModelEMA wired in (fixes unused main/model_ema.py)
        self.ema_decay = cfg.get("ema_decay", 0.9999)
        self.ema_tau = cfg.get("ema_tau", 2000)
        # mosaic/mixup probabilities: explicit plan keys win; otherwise the
        # enhance YAML's values apply (the reference hard-codes prob 0.5 and
        # ignores enhance.yaml, main/data_loader.py:14-23 — config-driven
        # here); final fallback matches the reference's hard-coded 0.5.
        ed = self.enhance_dict
        self.mosaic_prob = cfg.get("mosaic_prob", ed.get("mosaic", 0.5))
        self.mixup_prob = cfg.get("mixup_prob", ed.get("mix-up", 0.5))
        self.mosaic = cfg.get("mosaic", self.mosaic_prob > 0)
        self.mixup = cfg.get("mixup", self.mixup_prob > 0)
        self.use_perspective = cfg.get("use_perspective", False)
        self.special_aug_ratio = cfg.get("special_aug_ratio", 0.7)
        self.seed = cfg.get("seed", 0)
        self.cache_images = cfg.get("cache_images", False)
        # mAP-gated validation: every N epochs run the mAP evaluator on the
        # EMA weights and keep a best-mAP checkpoint (the reference gates on
        # train loss only, train.py:103-116; mAP is a new capability). 0=off.
        self.val_map_every = cfg.get("val_map_every", 0)

        # save / resume
        self.resume = cfg["resume"]
        self.save_dir = str(cfg["save_dir"]).replace("\\", "/")
        self.save_name = cfg["save_name"]
        self.save_path = os.path.join(self.save_dir, "{}.msgpack".format(self.save_name))

    def __str__(self):
        info = "-" * 20 + type(self).__name__ + "-" * 20 + "\r\n"
        for key, value in self.__dict__.items():
            if key not in ("cfg", "_path"):
                info += "%20s :\t%s\r\n" % (key, value)
        return info
