"""Vision models of the paper's own FL experiments (Table I), the port of
the JAX package's `models/cnn.py`:

  MNIST        -> two-layer CNN          (paper §IV-A)
  CIFAR-10     -> ResNet-18
  AI-READI     -> ResNet-50
  Fed-ISIC2019 -> EfficientNet-lite (depthwise-separable MBConv stack)

Parameters are nested dicts and lists of fp32 tensors with the JAX
package's keys, shapes and layouts: conv weights HWIO (a depthwise one
`(3, 3, 1, c)`), dense weights `(in, out)`, batch-norm `scale`/`bias`.
Activations enter and leave NHWC. Inside, the forward runs NCHW for
`F.conv2d` (cuDNN on the card), each weight taking its OIHW view at the
call. There is no hand-written kernel on this path: the JAX package
computes its convolutions, pooling and products in `lax`, not Pallas.

XLA's SAME padding puts the odd row and column of a stride-2 window
after the input (7x7/2 on 32 px pads (2, 3); 3x3/2 on 16 px (0, 1)),
where torch's `padding=` is symmetric, so `_pad_same` pads explicitly
when the two sides differ, with -inf for max pooling.

EfficientNet's strides are not in its parameter tree: they follow from
the architecture (`EFF_STRIDES`). The JAX package keeps each block's
stride as an int leaf beside its parameters, which makes `jax.grad`
over its tree fail (ROADMAP §3, fault (d)); `common/bridge.py` drops
and restores those leaves.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.bridge import tree_map
from repro_torch.common.device import require_device


def _conv_init(gen, shape):
    fan_in = shape[0] * shape[1] * shape[2]
    return torch.randn(shape, generator=gen) * math.sqrt(2 / fan_in)


def _dense_init(gen, shape):
    return torch.randn(shape, generator=gen) / math.sqrt(shape[0])


def _same_pad(size, k, stride):
    """(before, after) of XLA's SAME padding along one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kh, kw, stride, value=0.0):
    """NCHW `x` and the symmetric padding left for the op to apply."""
    (t, b), (l, r) = (_same_pad(x.shape[2], kh, stride),
                      _same_pad(x.shape[3], kw, stride))
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


def conv2d(x, w, stride=1, groups=1):
    """SAME convolution of NCHW `x` with the HWIO weight `w`."""
    x, pad = _pad_same(x, w.shape[0], w.shape[1], stride)
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride, padding=pad,
                    groups=groups)


def batch_norm(x, p, eps=1e-5):
    """Batch statistics over (N, H, W) of NCHW `x`, population variance,
    no running stats (the JAX package's `batch_norm`)."""
    mean = torch.mean(x, dim=(0, 2, 3), keepdim=True)
    var = torch.var(x, dim=(0, 2, 3), correction=0, keepdim=True)
    return ((x - mean) * torch.rsqrt(var + eps) * p["scale"][:, None, None]
            + p["bias"][:, None, None])


def _bn_params(c):
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def _nchw(x):
    return x.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Two-layer CNN (MNIST).
# ---------------------------------------------------------------------------
def init_small_cnn(gen, n_classes=10, in_ch=1):
    return {
        "c1": _conv_init(gen, (5, 5, in_ch, 32)),
        "c2": _conv_init(gen, (5, 5, 32, 64)),
        "fc1": _dense_init(gen, (64 * 7 * 7, 128)),
        "fc2": _dense_init(gen, (128, n_classes)),
    }


def small_cnn(p, x):
    x = F.relu(conv2d(_nchw(x), p["c1"]))
    x = F.max_pool2d(x, 2, 2)
    x = F.relu(conv2d(x, p["c2"]))
    x = F.max_pool2d(x, 2, 2)
    # fc1's rows run (h, w, c), the JAX package's NHWC flatten
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ p["fc1"])
    return x @ p["fc2"]


# ---------------------------------------------------------------------------
# ResNet (18 / 50).
# ---------------------------------------------------------------------------
def _init_basic_block(gen, cin, cout, stride):
    p = {
        "c1": _conv_init(gen, (3, 3, cin, cout)), "bn1": _bn_params(cout),
        "c2": _conv_init(gen, (3, 3, cout, cout)), "bn2": _bn_params(cout),
    }
    if stride != 1 or cin != cout:
        p["proj"] = _conv_init(gen, (1, 1, cin, cout))
        p["bnp"] = _bn_params(cout)
    return p


def _basic_block(p, x, stride):
    h = F.relu(batch_norm(conv2d(x, p["c1"], stride), p["bn1"]))
    h = batch_norm(conv2d(h, p["c2"]), p["bn2"])
    if "proj" in p:
        x = batch_norm(conv2d(x, p["proj"], stride), p["bnp"])
    return F.relu(x + h)


def _init_bottleneck(gen, cin, cmid, stride):
    cout = cmid * 4
    p = {
        "c1": _conv_init(gen, (1, 1, cin, cmid)), "bn1": _bn_params(cmid),
        "c2": _conv_init(gen, (3, 3, cmid, cmid)), "bn2": _bn_params(cmid),
        "c3": _conv_init(gen, (1, 1, cmid, cout)), "bn3": _bn_params(cout),
    }
    if stride != 1 or cin != cout:
        p["proj"] = _conv_init(gen, (1, 1, cin, cout))
        p["bnp"] = _bn_params(cout)
    return p


def _bottleneck(p, x, stride):
    h = F.relu(batch_norm(conv2d(x, p["c1"]), p["bn1"]))
    h = F.relu(batch_norm(conv2d(h, p["c2"], stride), p["bn2"]))
    h = batch_norm(conv2d(h, p["c3"]), p["bn3"])
    if "proj" in p:
        x = batch_norm(conv2d(x, p["proj"], stride), p["bnp"])
    return F.relu(x + h)


_RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    50: ("bottleneck", (3, 4, 6, 3)),
}


def init_resnet(gen, depth=18, n_classes=10, in_ch=3, width=64):
    kind, blocks = _RESNET_SPECS[depth]
    p = {"stem": _conv_init(gen, (7, 7, in_ch, width)),
         "bn_stem": _bn_params(width), "stages": []}
    cin = width
    for si, n in enumerate(blocks):
        cmid = width * (2 ** si)
        stage = []
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            if kind == "basic":
                stage.append(_init_basic_block(gen, cin, cmid, stride))
                cin = cmid
            else:
                stage.append(_init_bottleneck(gen, cin, cmid, stride))
                cin = cmid * 4
        p["stages"].append(stage)
    p["fc"] = _dense_init(gen, (cin, n_classes))
    return p


def resnet(p, x, depth=18):
    kind, _ = _RESNET_SPECS[depth]
    x = F.relu(batch_norm(conv2d(_nchw(x), p["stem"], 2), p["bn_stem"]))
    x, pad = _pad_same(x, 3, 3, 2, value=-math.inf)
    x = F.max_pool2d(x, 3, 2, padding=pad)
    fn = _basic_block if kind == "basic" else _bottleneck
    for si, stage in enumerate(p["stages"]):
        for bi, bp in enumerate(stage):
            x = fn(bp, x, 2 if (bi == 0 and si > 0) else 1)
    x = torch.mean(x, dim=(2, 3))
    return x @ p["fc"]


# ---------------------------------------------------------------------------
# EfficientNet-lite (MBConv stack) — Fed-ISIC2019.
# ---------------------------------------------------------------------------
_EFF_STAGES = (  # (expand, cout, n, stride)
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 40, 2, 2), (6, 80, 3, 2),
    (6, 112, 3, 1), (6, 192, 4, 2), (6, 320, 1, 1),
)
# each MBConv block's stride, in the order of `params["blocks"]`
EFF_STRIDES = [stride if bi == 0 else 1
               for _, _, n, stride in _EFF_STAGES for bi in range(n)]


def _init_mbconv(gen, cin, cout, expand):
    cmid = cin * expand
    p = {}
    if expand != 1:
        p["exp"] = _conv_init(gen, (1, 1, cin, cmid))
        p["bn_exp"] = _bn_params(cmid)
    p.update({"dw": _conv_init(gen, (3, 3, 1, cmid)),
              "bn_dw": _bn_params(cmid),
              "pw": _conv_init(gen, (1, 1, cmid, cout)),
              "bn_pw": _bn_params(cout)})
    return p


def _mbconv(p, x, stride):
    h = x
    if "exp" in p:
        h = F.relu6(batch_norm(conv2d(h, p["exp"]), p["bn_exp"]))
    h = F.relu6(batch_norm(conv2d(h, p["dw"], stride, groups=h.shape[1]),
                           p["bn_dw"]))
    h = batch_norm(conv2d(h, p["pw"]), p["bn_pw"])
    if stride == 1 and x.shape[1] == h.shape[1]:
        h = x + h
    return h


def init_efficientnet(gen, n_classes=8, in_ch=3):
    p = {"stem": _conv_init(gen, (3, 3, in_ch, 32)),
         "bn_stem": _bn_params(32), "blocks": []}
    cin = 32
    for expand, cout, n, _ in _EFF_STAGES:
        for _ in range(n):
            p["blocks"].append(_init_mbconv(gen, cin, cout, expand))
            cin = cout
    p["head"] = _conv_init(gen, (1, 1, cin, 1280))
    p["bn_head"] = _bn_params(1280)
    p["fc"] = _dense_init(gen, (1280, n_classes))
    return p


def efficientnet(p, x):
    x = F.relu6(batch_norm(conv2d(_nchw(x), p["stem"], 2), p["bn_stem"]))
    for bp, s in zip(p["blocks"], EFF_STRIDES):
        x = _mbconv(bp, x, s)
    x = F.relu6(batch_norm(conv2d(x, p["head"]), p["bn_head"]))
    x = torch.mean(x, dim=(2, 3))
    return x @ p["fc"]


# ---------------------------------------------------------------------------
# Registry used by the FL layer.
# ---------------------------------------------------------------------------
MODELS = ("small_cnn", "resnet18", "resnet50", "efficientnet")


def build(name: str, gen: torch.Generator, n_classes: int, in_ch: int,
          img: int, device="cuda") -> Tuple[dict, Callable, tuple]:
    """Returns (params, apply_fn, input_shape): parameters drawn from
    the CPU generator `gen` (the same on every device) and put on
    `device`, and the NHWC forward."""
    dev = require_device(device, "cnn.build")
    if name == "small_cnn":
        p, fn = init_small_cnn(gen, n_classes, in_ch), small_cnn
    elif name in ("resnet18", "resnet50"):
        depth = int(name[len("resnet"):])
        p = init_resnet(gen, depth, n_classes, in_ch)

        def fn(pp, x, depth=depth):
            return resnet(pp, x, depth)
    elif name == "efficientnet":
        p, fn = init_efficientnet(gen, n_classes, in_ch), efficientnet
    else:
        raise ValueError(name)
    return tree_map(lambda t: t.to(dev), p), fn, (img, img, in_ch)
