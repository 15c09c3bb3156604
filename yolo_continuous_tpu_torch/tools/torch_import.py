"""Reference (torch) checkpoints into the port's models (counterpart of
``yolo_continuous_tpu/tools/torch_import.py``: ``convert_state_dict``,
``load_torch_checkpoint``, ``convert_body_state_dict``,
``load_torch_body_checkpoint``).

The port's modules carry the reference's names and layouts
(``nets/yolo.Model``'s ``model.{i}.conv.weight``, ``rbr_dense.0``, ...), so
a reference ``state_dict`` mostly loads as it is. What the JAX importer
adds, and this module keeps, is its name fallback (``_candidates``): a key
of the port's model that the file lacks is looked up with one intermediate
path segment dropped at a time (a wrapper such as DWConv's ``conv``), after
the layer prefix (``model.{i}``, and ``.{k}`` inside a repeated row).
``num_batches_tracked`` entries are optional both ways: a file without them
(the JAX package's ``export_state_dict`` writes none) keeps the model's,
and leftovers of that name are ignored. Values keep the model's dtype;
every shape must match.

The hard-coded family (``nn/yolo_body.py``: YoloBody, Backbone) has no layer
prefix: any segment may be dropped, so a bare-Backbone checkpoint (the
reference's pretrained download, ``nets/backbone.py:118-125``) loads into a
Backbone, and a YoloBody checkpoint into a YoloBody.
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

StateDict = Dict[str, torch.Tensor]
_NBT = "num_batches_tracked"


def _candidates(key: str, prefix: int) -> List[str]:
    """``key``, then ``key`` with one segment between its first ``prefix``
    segments and its leaf dropped, most specific first."""
    toks = key.split(".")
    head, rest, leaf = toks[:prefix], toks[prefix:-1], toks[-1:]
    return [key] + [".".join(head + rest[:i] + rest[i + 1:] + leaf) for i in range(len(rest))]


def _yolo_prefix(model: nn.Module, key: str) -> int:
    """Segments of the layer prefix of a ``YoloModel`` key: ``model.{i}``, and
    ``.{k}`` when row i is a repeat (an ``nn.Sequential`` of its blocks)."""
    toks = key.split(".")
    if len(toks) > 3 and toks[0] == "model" and toks[1].isdigit():
        row = model.model[int(toks[1])]
        return 3 if isinstance(row, nn.Sequential) and toks[2].isdigit() else 2
    return 1


def _convert(state_dict: StateDict, model: nn.Module, prefix_of, strict: bool) -> StateDict:
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    out, used = {}, set()
    for key, ours in model.state_dict().items():
        found = next((c for c in _candidates(key, prefix_of(key)) if c in sd), None)
        if found is None:
            if strict and not key.endswith(_NBT):
                raise KeyError(f"no torch key for {key}; tried {_candidates(key, prefix_of(key))[:3]}...")
            out[key] = ours.detach().clone()
            continue
        val = sd[found]
        if tuple(val.shape) != tuple(ours.shape):
            raise ValueError(f"{key} <- {found}: shape {tuple(val.shape)}, want {tuple(ours.shape)}")
        used.add(found)
        out[key] = val.detach().to(ours.dtype).clone()
    leftovers = [k for k in sd if k not in used and not k.endswith(_NBT)]
    if strict and leftovers:
        raise KeyError(f"unconsumed torch keys: {leftovers[:5]} ({len(leftovers)} total)")
    return out


def _template(spec_or_model) -> nn.Module:
    if isinstance(spec_or_model, nn.Module):
        return spec_or_model
    from ..nn.builder import YoloModel
    return YoloModel(spec_or_model)


def convert_state_dict(state_dict: StateDict, spec_or_model, strict: bool = True) -> StateDict:
    """A reference ``state_dict`` -> the state dict of the ``YoloModel`` of
    ``spec_or_model`` (a ``ModelSpec`` or the model), which loads with
    ``load_state_dict(strict=True)``."""
    model = _template(spec_or_model)
    return _convert(state_dict, model, lambda k: _yolo_prefix(model, k), strict)


def load_torch_checkpoint(path: str, spec_or_model, strict: bool = True) -> StateDict:
    """``convert_state_dict`` of a ``.pth`` file."""
    return convert_state_dict(torch.load(path, map_location="cpu", weights_only=True),
                              spec_or_model, strict)


def convert_body_state_dict(state_dict: StateDict, model: nn.Module,
                            strict: bool = True) -> StateDict:
    """A reference ``nets/yolo_net.YoloBody`` / ``nets/backbone.Backbone``
    ``state_dict`` -> the state dict of ``model`` (``nn/yolo_body.py``)."""
    return _convert(state_dict, model, lambda k: 0, strict)


def load_torch_body_checkpoint(path: str, model: nn.Module,
                               strict: bool = True) -> StateDict:
    """``convert_body_state_dict`` of a ``.pth`` file."""
    return convert_body_state_dict(torch.load(path, map_location="cpu", weights_only=True),
                                   model, strict)

