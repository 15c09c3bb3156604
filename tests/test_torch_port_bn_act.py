"""Eval BatchNorm's ``bn_act`` (``kernels/bn_act.py``) without a card: what its
wrapper refuses before it looks for one, the activation codes it shares with
``csrc/bn_act.cu`` and ``nn.layers.apply_act``, and the eval branch of
``BatchNorm2d`` on CPU tensors, which keeps the plain expression. The kernel
itself is held to that expression bit for bit on the card
(``tests/test_torch_port_cuda.py``, marker ``cuda``)."""
import re

import pytest
import torch
import torch.nn.functional as F

from yolo_continuous_tpu_torch.config.plan import TrainPlan
from yolo_continuous_tpu_torch.detect_api import Detector
from yolo_continuous_tpu_torch.kernels import _build
from yolo_continuous_tpu_torch.kernels import bn_act as K
from yolo_continuous_tpu_torch.nn import layers
from yolo_continuous_tpu_torch.nn.layers import BatchNorm2d, apply_act

ACTS = [True, "silu", "relu", "leaky_relu", ("leaky_relu", 0.1), "hardswish", None, False,
        "identity"]


def _params(c=4):
    return [torch.ones(c), torch.zeros(c), torch.zeros(c), torch.ones(c)]


def _refusals():
    x = torch.zeros(2, 4, 3, 5)
    p = _params()
    wrong = {
        "fp64 x": (x.double(), p),
        "int8 x": (x.to(torch.int8), p),
        "3-d x": (x[0], p),
        "non-contiguous view": (x[:, :, ::2], p),
        "transposed view": (x.transpose(2, 3), p),
        "weight of C + 1": (x, [torch.ones(5)] + p[1:]),
        "bias (C, 1)": (x, [p[0], torch.zeros(4, 1)] + p[2:]),
        "fp16 running_var": (x, p[:3] + [torch.ones(4, dtype=torch.float16)]),
        "strided running_mean": (x, p[:2] + [torch.zeros(8)[::2]] + p[3:]),
        "channels-last map": (x.to(memory_format=torch.channels_last), p),
    }
    return [pytest.param(x, p, id=k) for k, (x, p) in wrong.items()]


@pytest.mark.parametrize("x,params", _refusals())
def test_check_refuses_before_it_looks_for_a_card(x, params):
    with pytest.raises(ValueError, match="^bn_act: ") as e:
        K._check(x, *params)
    assert "CUDA" not in str(e.value)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_check_takes_each_dtype_and_then_wants_a_card(dtype):
    x = torch.zeros(2, 4, 3, 5, dtype=dtype)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        K._check(x, *_params())
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        K.bn_act(x, *_params(), 1e-5, True)


@pytest.mark.parametrize("act", ACTS, ids=str)
def test_apply_act_keeps_every_spec(act):
    x = torch.linspace(-6, 6, 97)
    want = {True: F.silu, "silu": F.silu, "relu": F.relu, "hardswish": F.hardswish,
            "leaky_relu": lambda t: F.leaky_relu(t, 0.01)}
    if isinstance(act, tuple):
        fn = (lambda t: F.leaky_relu(t, act[1]))
    else:
        fn = want.get(act, lambda t: t)
    assert torch.equal(apply_act(x, act), fn(x))


def test_unknown_activation_spec_raises():
    with pytest.raises(ValueError, match="unknown activation spec"):
        K.act_code("gelu")


def test_activation_codes_are_the_kernels():
    """The Python codes, dtypes and entry point copy ``csrc/bn_act.cu``'s."""
    src = (_build.CSRC / "bn_act.cu").read_text()
    enum = re.search(r"enum Act \{([^}]*)\}", src).group(1)
    codes = {k.strip(): int(v) for k, v in (e.split("=") for e in enum.split(","))}
    assert codes == {"kIdentity": K.IDENTITY, "kSilu": K.SILU, "kRelu": K.RELU,
                     "kLeaky": K.LEAKY, "kHardswish": K.HARDSWISH}
    assert "dtype: 0 fp32, 1 bf16, 2 fp16" in src
    assert K.DTYPES == {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    assert set(_build.SIGNATURES["bn_act"]) == {"bn_act"}


def _old_expression(bn, x, act):
    """The eval branch as it was written before the kernel, spelled out."""
    inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    shift = bn.bias - bn.running_mean * inv
    return apply_act(x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None], act)


@pytest.mark.parametrize("act", [True, "relu", ("leaky_relu", 0.1), "hardswish", None], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_batchnorm_on_the_cpu_keeps_the_plain_expression(monkeypatch, dtype, act):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel")
    monkeypatch.setattr(layers, "bn_act", refuse)
    g = torch.Generator().manual_seed(0)
    bn = BatchNorm2d(6, eps=1e-3).eval()
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.randn(6, generator=g))
        bn.running_var.copy_(torch.rand(6, generator=g) + 0.1)
    x = torch.randn(2, 6, 5, 7, generator=g).to(dtype)
    before = K.bn_act.launches
    with torch.inference_mode():
        got = bn(x, act)
        want = _old_expression(bn, x, act)
    assert K.bn_act.launches == before
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(K.bn_act_plain(x, bn.weight.detach(), bn.bias.detach(), bn.running_mean,
                                      bn.running_var, bn.eps, act), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_batchnorm_folds_as_before(dtype):
    """``_bn_train`` folds through ``bn_act.fold``: the same bits as the
    expression it spelled out before, forward and backward."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 6, 5, 7, generator=g).to(dtype)
    w = (torch.randn(6, generator=g) + 1).requires_grad_()
    b = torch.randn(6, generator=g).requires_grad_()
    got, mean, var = layers._bn_train(x, w, b, 1e-3, True)
    inv = w * torch.rsqrt(var + 1e-3)
    shift = b - mean * inv
    want = apply_act(x * inv.to(dtype)[:, None, None] + shift.to(dtype)[:, None, None], True)
    assert torch.equal(got, want)
    grads = [torch.autograd.grad(y.float().sum(), (w, b)) for y in (got, want)]
    assert all(torch.equal(p, q) for p, q in zip(*grads))


@pytest.mark.parametrize("fused_tails,calls", [(False, 92), (True, 68)])
def test_yolov7_request_has_92_eval_batchnorms(fused_tails, calls):
    """yolov7's eval BatchNorm calls a request: each is one launch of the
    kernel on the card (``fused_tails`` folds 24 into K5)."""
    plan = TrainPlan("cfg/chip_tiny.yaml")
    plan.model_cfg, plan.image_size = "cfg/net/yolov7.yaml", 64
    det = Detector(plan, device="cpu", seed=0, fused_tails=fused_tails)
    n = [0]
    for m in det.model.modules():
        if isinstance(m, BatchNorm2d):
            m.register_forward_hook(lambda *a: n.__setitem__(0, n[0] + 1))
    with torch.inference_mode():
        det.forward(torch.rand(1, 64, 64, 3))
    assert n[0] == calls
