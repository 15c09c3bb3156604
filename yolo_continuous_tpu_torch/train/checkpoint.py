"""Checkpoints: the port's full training state, and the JAX package's files.

Counterpart of ``yolo_continuous_tpu/train/checkpoint.py``. The port's
checkpoint is a torch file of the whole training state (model, EMA,
optimizer, step, the EMA counter), so a resumed run continues exactly. It
lives beside the plan's ``save_path`` as ``<save_path without .msgpack>.train.pt``
(``train_checkpoint_path``), and is replaced atomically: written to
``.tmp``, then ``os.replace`` (``checkpoint.py:19-26``), so a crash never
leaves a torn file.

``read_jax_msgpack`` reads a checkpoint that the JAX package wrote (flax
``to_bytes`` of ``{"params", "batch_stats", "opt", "ema", "step"}``) with
``msgpack`` alone, as the GPU machine has no flax: an ndarray arrives as
``ExtType(1, packb((shape, dtype_name, raw_bytes)))``, a numpy scalar as
``ExtType(3, ...)`` in the same layout, and a NamedTuple (``EMAState``,
``SGDState``) as a dict of its field names. (flax splits an array above
1 GiB into chunks, and writes bfloat16 by a name numpy lacks; a JAX train
state holds neither: its leaves are fp32 and int32, each far below 1 GiB.)
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

TRAIN_SUFFIX = ".train.pt"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def train_checkpoint_path(save_path: str) -> str:
    """The port's train checkpoint beside a plan's ``save_path``
    (``runs/x.msgpack`` -> ``runs/x.train.pt``)."""
    return os.path.splitext(save_path)[0] + TRAIN_SUFFIX


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Write the training state of ``Trainer.init_state`` atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = {"model": state["model"].state_dict(), "opt": state["opt"].state_dict(),
            "ema": state["ema"].state_dict(), "step": int(state["step"])}
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """The saved dict: ``model`` and ``opt`` state dicts, ``ema`` (``tree``,
    ``updates``) and ``step``."""
    return torch.load(path, map_location=map_location, weights_only=True)


def try_load(path: str, state: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Load the checkpoint at ``path`` into ``state`` (in place) and return
    it; None if there is no file."""
    if not (path and os.path.exists(path)):
        return None
    blob = load_checkpoint(path)
    state["model"].load_state_dict(blob["model"], strict=True)
    state["opt"].load_state_dict(blob["opt"])
    state["ema"].load_state_dict(blob["ema"])
    state["step"] = int(blob["step"])
    return state


def serving_state_dict(blob: Dict[str, Any], use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The model state dict of a saved train checkpoint: its EMA values (the
    serving weights) unless ``use_ema`` is false."""
    if not use_ema:
        return blob["model"]
    return {k: blob["ema"]["tree"].get(k, v) for k, v in blob["model"].items()}


def _array(data: bytes) -> np.ndarray:
    import msgpack
    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buf, np.dtype(dtype.decode())).reshape(shape).copy()


def _ext_hook(code: int, data: bytes):
    import msgpack
    if code == _EXT_NDARRAY:
        return _array(data)
    if code == _EXT_NPSCALAR:
        return _array(data)[()]
    return msgpack.ExtType(code, data)


def read_jax_msgpack(path: str) -> Dict[str, Any]:
    """A JAX package checkpoint as nested dicts of numpy arrays."""
    import msgpack
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)


def jax_weights(ckpt: Dict[str, Any], use_ema: bool = True) -> Tuple[dict, dict]:
    """(params, batch_stats) of a JAX checkpoint: the EMA tree (the serving
    weights, as the JAX ``Detector`` and ``Trainer.warm_start`` take them)
    or the raw ones."""
    if use_ema:
        tree = ckpt["ema"]["tree"]
        return tree["params"], tree.get("batch_stats", {})
    return ckpt["params"], ckpt.get("batch_stats", {})
