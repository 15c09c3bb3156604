"""JAX parameter trees -> the port's state_dict.

Counterpart of ``yolo_continuous_tpu/tools/torch_import.export_state_dict``:
the JAX package's (params, batch_stats) trees, as nested dicts of numpy
arrays, become a ``state_dict`` of the port's ``YoloModel`` that loads with
``load_state_dict(strict=True)``. ``_rewrite_tokens``, ``_torch_key`` (the
first of ``_candidates``) and ``_invert_value`` are this package's own
copies of the JAX package's name rules (``torch_import.py:37-121,
301-310``), so the port imports nothing of it. ``num_batches_tracked``,
which export never writes and
``nn.BatchNorm2d`` expects, is added as 0 for every BatchNorm.
"""
from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..nn.builder import ModelSpec


def _rewrite_tokens(rest):
    """JAX-path -> torch-path token rewrites (copy of torch_import.py:37-86)."""
    out = []
    i = 0
    while i < len(rest):
        t = rest[i]
        # our BatchNorm wrapper nests an inner module also named 'bn'
        if t == "bn" and i + 1 < len(rest) and rest[i + 1] == "bn":
            out.append("bn")
            i += 2
            continue
        # RepConv branches: Sequential(conv, bn) in torch
        if t == "rbr_dense_conv":
            out.append("rbr_dense.0")
        elif t == "rbr_dense_bn":
            out.append("rbr_dense.1")
            if i + 1 < len(rest) and rest[i + 1] == "bn":
                i += 1  # its BatchNorm wrapper adds another 'bn'
        elif t == "rbr_1x1_conv":
            out.append("rbr_1x1.0")
        elif t == "rbr_1x1_bn":
            out.append("rbr_1x1.1")
            if i + 1 < len(rest) and rest[i + 1] == "bn":
                i += 1
        elif t == "rbr_identity":
            out.append("rbr_identity")
            if i + 1 < len(rest) and rest[i + 1] == "bn":
                i += 1
        # Detect head conv names
        elif t in ("head_p3", "head_p4", "head_p5"):
            out.append("yolo_head_" + t[-2:].upper())
        # IDetect/IBin/IAux lists: m0 -> m.0, ia0 -> ia.0, im0 -> im.0
        elif re.fullmatch(r"(m2?|ia|im)\d+", t):
            mm = re.fullmatch(r"(m2?|ia|im)(\d+)", t)
            out.append(f"{mm.group(1)}.{mm.group(2)}")
        elif re.fullmatch(r"m2_(\d+)", t):
            out.append(f"m2.{t.split('_')[1]}")
        # CSP inner chain: m0 -> m.0
        elif re.fullmatch(r"m\d+", t):
            out.append(f"m.{t[1:]}")
        # Ghost bottleneck: conv0/conv2 -> conv.0/conv.2; short -> shortcut
        elif re.fullmatch(r"conv\d+", t):
            out.append(f"conv.{t[4:]}")
        elif re.fullmatch(r"short\d+", t):
            out.append(f"shortcut.{t[5:]}")
        else:
            out.append(t)
        i += 1
    return out


_LEAF_TORCH = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
               "var": "running_var"}


def _torch_key(path_tokens, leaf, spec: ModelSpec) -> str:
    """Torch state_dict key of one JAX parameter path: the canonical (first)
    candidate of ``torch_import._candidates`` (``torch_import.py:93-121``)."""
    toks = list(path_tokens)
    head_names = {"detect", "idetect", "iauxdetect", "ibin"}

    # layer prefix
    m = re.match(r"l(\d+)_(.+?)(?:_r(\d+))?$", toks[0])
    if m:
        prefix = f"model.{m.group(1)}"
        if m.group(3) is not None:
            prefix += f".{m.group(3)}"
        rest = toks[1:]
    elif toks[0] in head_names:
        prefix = f"model.{spec.head_index}"
        rest = toks[1:]
    else:
        prefix = toks[0]
        rest = toks[1:]
    return ".".join([prefix] + _rewrite_tokens(rest) + [_LEAF_TORCH.get(leaf, leaf)])


def _invert_value(leaf: str, ours: np.ndarray) -> np.ndarray:
    t = np.asarray(ours)
    if leaf == "kernel":
        if t.ndim == 4:       # (kh, kw, cin/g, cout) -> (cout, cin/g, kh, kw)
            t = t.transpose(3, 2, 0, 1)
        elif t.ndim == 2:
            t = t.transpose(1, 0)
    if leaf == "implicit" and t.ndim == 4:  # (1,1,1,c) -> (1,c,1,1)
        t = t.transpose(0, 3, 1, 2)
    return t


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def state_dict_from_jax(spec: ModelSpec, params, batch_stats) -> Dict[str, torch.Tensor]:
    """(params, batch_stats) nested dicts of arrays -> the port's state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats or {}):
        for path, val in _leaves(tree):
            key = _torch_key(path[:-1], path[-1], spec)
            out[key] = torch.from_numpy(np.array(_invert_value(path[-1], val)))
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return out
