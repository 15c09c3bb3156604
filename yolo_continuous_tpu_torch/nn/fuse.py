"""Deploy-time re-parameterization as pure weight transforms.

Counterpart of ``yolo_continuous_tpu/nn/fuse.py`` (parity targets
``nets/common.py:488-529`` RepConv.get_equivalent_kernel_bias,
``nets/common.py:538-559`` the conv+BN fold, ``nets/yolo_net.py:274-283``
the model-level fuse). The functions map the port's train-form state dict
to the state dict of the deploy-form model (``RepConv(deploy=True)``), built
from ``deploy_spec(spec)``. The fold runs in fp32 on the fp32 master
weights, in JAX's order of operations; the deploy form then runs in the
body dtype (``layers.BiasConv2d`` adds its bias after the rounded
convolution, as flax does).

Layout: the port's conv weights are ``(cout, cin/g, kh, kw)``, JAX's
``(kh, kw, cin/g, cout)``; the per-output-channel factor multiplies the
first axis here and the last there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .builder import ModelSpec

_BRANCHES = ("rbr_dense.", "rbr_1x1.", "rbr_identity.")


def fuse_conv_bn(weight: torch.Tensor, bn: Dict[str, torch.Tensor],
                 eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weight, bn{weight, bias, running_mean, running_var}) -> (weight',
    bias'); nets/common.py:538-544."""
    std = torch.sqrt(bn["running_var"] + eps)
    t = bn["weight"] / std                           # (cout,)
    return weight * t[:, None, None, None], bn["bias"] - bn["running_mean"] * t


def _identity_kernel(c: int, groups: int) -> torch.Tensor:
    """3x3 identity kernel ``(c, c/groups, 3, 3)``; nets/common.py:515-520."""
    cin_g = c // groups
    k = torch.zeros(c, cin_g, 3, 3)
    k[torch.arange(c), torch.arange(c) % cin_g, 1, 1] = 1.0
    return k


def _bn(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k: sd[prefix + k].float() for k in ("weight", "bias", "running_mean", "running_var")}


def fuse_repconv(sd: Dict[str, torch.Tensor], c1: int, c2: int, groups: int = 1,
                 eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """A train-form RepConv's state dict (keys relative to the RepConv) ->
    the deploy form's ``{"rbr_reparam.weight", "rbr_reparam.bias"}``;
    get_equivalent_kernel_bias, nets/common.py:488-495."""
    k3, b3 = fuse_conv_bn(sd["rbr_dense.0.weight"].float(), _bn(sd, "rbr_dense.1."), eps)
    k1, b1 = fuse_conv_bn(sd["rbr_1x1.0.weight"].float(), _bn(sd, "rbr_1x1.1."), eps)
    kernel = k3 + F.pad(k1, (1, 1, 1, 1))
    bias = b3 + b1
    if "rbr_identity.weight" in sd:          # only when c1 == c2 and s == 1
        kid, bid = fuse_conv_bn(_identity_kernel(c1, groups), _bn(sd, "rbr_identity."), eps)
        kernel = kernel + kid
        bias = bias + bid
    return {"rbr_reparam.weight": kernel, "rbr_reparam.bias": bias}


def deploy_spec(spec: ModelSpec) -> ModelSpec:
    """Flip every RepConv row's deploy flag (arg index 5 of
    (k, s, p, g, act, deploy)); a copy of JAX ``fuse.deploy_spec``."""
    new_layers = []
    for s in spec.layers:
        if s.name == "RepConv":
            a = list(s.args) + [None] * (6 - len(s.args))
            if a[0] is None:
                a[0] = 3
            if a[1] is None:
                a[1] = 1
            if a[3] is None:
                a[3] = 1
            if a[4] is None:
                a[4] = True
            a[5] = True
            s = dataclasses.replace(s, args=tuple(a))
        new_layers.append(s)
    return dataclasses.replace(spec, layers=tuple(new_layers))


def fuse_model_params(spec: ModelSpec, state_dict: Dict[str, torch.Tensor],
                      eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """Train-form state dict -> the state dict of
    ``YoloModel(deploy_spec(spec))``. The RepConv rows (each repeat of one)
    are re-parameterized, their branch weights and BN statistics consumed;
    every other entry passes through, RepConvs nested in other blocks too,
    as JAX ``fuse_model_params`` does."""
    out = dict(state_dict)
    for s in spec.layers:
        if s.name != "RepConv":
            continue
        g = s.args[3] if len(s.args) > 3 and s.args[3] else 1
        prefixes = [f"model.{s.i}."] if s.n == 1 else [f"model.{s.i}.{r}." for r in range(s.n)]
        for prefix in prefixes:
            rel = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
            for k in rel:
                if k.startswith(_BRANCHES):
                    del out[prefix + k]
            out.update({prefix + k: v for k, v in fuse_repconv(rel, s.c1, s.c2, g, eps).items()})
    return out
