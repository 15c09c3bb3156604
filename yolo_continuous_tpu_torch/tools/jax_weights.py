"""JAX parameter trees -> the port's state_dict.

Counterpart of ``yolo_continuous_tpu/tools/torch_import.export_state_dict``:
the JAX package's (params, batch_stats) trees, as nested dicts of numpy
arrays, become a ``state_dict`` of the port's ``YoloModel`` that loads with
``load_state_dict(strict=True)``. ``_rewrite_tokens``, ``_torch_key`` (the
first of ``_candidates``), ``_body_key`` (the first of
``_body_candidates``) and ``_invert_value`` are this package's own copies
of the JAX package's name rules (``torch_import.py:37-121, 203-236,
301-310``), so the port imports nothing of it. ``num_batches_tracked``,
which export never writes and ``nn.BatchNorm2d`` expects, is added as 0 for
every BatchNorm.

Two rules are the port's own, because ``export_state_dict`` has none for
the transformer: flax's attention ``ma`` (``query``/``key``/``value``
kernels ``(c, heads, hd)`` and biases ``(heads, hd)``, ``out`` kernel
``(heads, hd, c)``) becomes torch's ``ma.in_proj_weight`` ``(3c, c)``,
``ma.in_proj_bias`` and ``ma.out_proj``; and the layers ``tr{i}`` become the
reference's ``tr.{i}``. ``body_state_dict_from_jax`` does the same for the
``nn/yolo_body.py`` family (YoloBody, Backbone, LayoutBody), and
``quant_state_from_jax`` for the int8 activation scales.
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
        # the port's own rule: TransformerBlock's layers tr0 -> tr.0
        elif re.fullmatch(r"tr\d+", t):
            out.append(f"tr.{t[2:]}")
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


def _attention(ma) -> Dict[str, np.ndarray]:
    """flax ``MultiHeadDotProductAttention`` params -> torch's
    ``nn.MultiheadAttention`` leaves (their names need no rewrite, their
    values no ``_invert_value``): output feature ``h * hd + d`` of the
    in-projection is flax's ``[h, d]``."""
    c = np.shape(ma["query"]["kernel"])[0]
    qkv = ("query", "key", "value")
    return {"in_proj_weight": np.concatenate(
                [np.asarray(ma[n]["kernel"]).reshape(c, -1).T for n in qkv], 0),
            "in_proj_bias": np.concatenate([np.asarray(ma[n]["bias"]).reshape(-1) for n in qkv]),
            "out_proj.weight": np.asarray(ma["out"]["kernel"]).reshape(-1, c).T,
            "out_proj.bias": np.asarray(ma["out"]["bias"])}


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k in sorted(tree):
        v = tree[k]
        if k == "ma" and isinstance(v, Mapping) and "query" in v:
            for name, val in _attention(v).items():
                yield prefix + (k, name), val
        elif isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _state_dict(trees, key_of) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for tree in trees:
        for path, val in _leaves(tree or {}):
            out[key_of(path[:-1], path[-1])] = torch.from_numpy(
                np.array(_invert_value(path[-1], val)))
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def state_dict_from_jax(spec: ModelSpec, params, batch_stats) -> Dict[str, torch.Tensor]:
    """(params, batch_stats) nested dicts of arrays -> the port's state_dict."""
    return _state_dict((params, batch_stats), lambda path, leaf: _torch_key(path, leaf, spec))


def quant_state_from_jax(spec: ModelSpec, quant) -> Dict[str, torch.Tensor]:
    """JAX's ``"quant"`` collection (the ``amax`` of every Conv, as nested
    dicts) -> ``YoloModel.load_quant_state``'s dict, under the port's module
    names (``l0_Conv/amax`` -> ``model.0.amax``), so that a model calibrated
    in JAX serves from the port with the same scales."""
    return {key: value.reshape(()).float() for key, value in
            _state_dict((quant,), lambda path, leaf: _torch_key(path, leaf, spec)).items()}


def _body_key(path_tokens, leaf) -> str:
    """Torch key of a YoloBody/Backbone/LayoutBody path: the canonical (first)
    candidate of ``torch_import._body_candidates`` (``torch_import.py:203-236``):
    the reference's Sequential stages ``stem.{i}``, ``dark{n}.0`` (conv or
    Transition), ``dark{n}.1`` (Block) and Block's ``cv3.{i}``."""
    toks = []
    for t in path_tokens:
        m = re.fullmatch(r"stem(\d)", t)
        if m:
            toks += ["stem", m.group(1)]
            continue
        m = re.fullmatch(r"(dark\d+)_(conv|tr)", t)
        if m:
            toks += [m.group(1), "0"]
            continue
        m = re.fullmatch(r"(dark\d+)_block", t)
        if m:
            toks += [m.group(1), "1"]
            continue
        m = re.fullmatch(r"cv(\d)_(\d+)", t)
        if m:
            toks += [f"cv{m.group(1)}", m.group(2)]
            continue
        toks.append(t)
    return ".".join(_rewrite_tokens(toks) + [_LEAF_TORCH.get(leaf, leaf)])


def body_state_dict_from_jax(params, batch_stats) -> Dict[str, torch.Tensor]:
    """A YoloBody/Backbone/LayoutBody (params, batch_stats) pair -> the state
    dict of the port's ``nn/yolo_body.py`` model of the same shape."""
    return _state_dict((params, batch_stats), _body_key)
