"""PyTorch port vs JAX package: the hard-coded family (nn/yolo_body.py).

The parameter counts of tests/test_yolo_body.py (the torch reference's:
YoloBody 'l' 37,297,025 and 'x' 70,940,649 with 20 classes; LayoutBody
1,855,812 at 416 px), and the outputs of YoloBody 'l' (64 px, RepConv heads,
P5 first), a small Backbone (64 px) and LayoutBody (128 px) against the JAX
modules, in fp32 eval, from the same ``lively`` weights carried across by
``body_state_dict_from_jax`` (``strict=True``), within 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import lively
from yolo_continuous_tpu.nn import yolo_body as jax_body
from yolo_continuous_tpu_torch.nn import yolo_body
from yolo_continuous_tpu_torch.tools.jax_weights import body_state_dict_from_jax

ATOL = 1e-5


def _count(m):
    return sum(p.numel() for p in m.parameters())


def test_parameter_counts_match_the_reference():
    assert _count(yolo_body.YoloBody(20, "l")) == 37_297_025
    assert _count(yolo_body.YoloBody(20, "x")) == 70_940_649
    assert _count(yolo_body.LayoutBody("l", image_size=416)) == 1_855_812


CASES = {
    "yolobody-l": (lambda: jax_body.YoloBody(num_classes=2, phi="l"),
                   lambda: yolo_body.YoloBody(2, "l"), 64),
    "backbone": (lambda: jax_body.Backbone(8, 8, 4, "l"),
                 lambda: yolo_body.Backbone(8, 8, 4, "l"), 64),
    "layout": (lambda: jax_body.LayoutBody(phi="l"),
               lambda: yolo_body.LayoutBody("l", image_size=128), 128),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_outputs_match_jax(name):
    make_jax, make_port, size = CASES[name]
    jm = make_jax()
    x = np.random.RandomState(0).rand(2, size, size, 3).astype(np.float32)
    v = jax.eval_shape(lambda k, a: jm.init(k, a, False), jax.random.PRNGKey(0),
                       jnp.asarray(x[:1]))
    rs = np.random.RandomState(1)
    params, stats = lively(v["params"], rs), lively(v["batch_stats"], rs)
    ref = jax.jit(jm.apply, static_argnums=2)({"params": params, "batch_stats": stats},
                                               jnp.asarray(x), False)
    ref = [np.asarray(r) for r in (ref if isinstance(ref, (list, tuple)) else [ref])]
    model = make_port().eval()
    model.load_state_dict(body_state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        ours = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    ours = list(ours) if isinstance(ours, (list, tuple)) else [ours]
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        o = o.numpy()
        if o.ndim == 4 and name == "backbone":          # features: NCHW here, NHWC there
            o = o.transpose(0, 2, 3, 1)
        assert o.shape == r.shape and np.abs(r).max() > 0.1
        np.testing.assert_allclose(o, r, rtol=0, atol=ATOL)


def test_bconv_batchnorm_is_the_reference_one():
    """eps 1e-3 and flax momentum 0.97 (torch 0.03), SiLU after the BN; the
    train-mode update moves the running mean by 3% of the batch mean."""
    m = yolo_body.BConv(3, 4, 3, 1).train()
    assert m.bn.eps == 1e-3 and m.bn.momentum == pytest.approx(0.03)
    x = torch.randn(2, 3, 8, 8)
    with torch.no_grad():
        m(x)
        mean = m.conv(x).mean((0, 2, 3))
    torch.testing.assert_close(m.bn.running_mean, 0.03 * mean, rtol=1e-5, atol=1e-6)
