"""The paper's 18 Keras CNNs as PyTorch layer graphs (Table I).

The port of ``repro/models/cnn_zoo.py``: the same nets with the same node
names, kinds, FLOPs, parameter bytes and topology, so they fuse into the
same blocks with the same partition points and cut bytes.  Weights are
random, as there: Scission benchmarks timing and output sizes, which do not
depend on trained weights.  NASNetMobile/NASNetLarge and InceptionResNetV2
are the reference's structurally faithful approximations (``APPROX``).

Each layer form is one small ``nn.Module`` (:class:`Conv`, :class:`Pool`,
:class:`GlobalAvgPool`, :class:`Dense`, :class:`Flatten`, :class:`Add`,
:class:`Concat`); a node's ``apply`` is its module's ``forward``, and the
graph keeps the modules by node name in ``graph.modules``, an
``nn.ModuleDict``, so ``load_state_dict`` carries weights in
(:func:`load_params`).

* **Layout.** Tensors between nodes are NHWC, as in the reference, so cut
  tensors have the same shapes and bytes.  Inside a module the NHWC tensor
  is viewed as NCHW by a permute, which makes a channels_last tensor that
  the convolution and pooling take as it is; conv weights are stored
  channels_last too, and the permute back hands on a contiguous NHWC
  tensor.  No layout copy is made.
* **Padding.** ``"SAME"`` pads as XLA does, the odd extra row and column at
  the end (:func:`same_pads`).  A conv pads explicitly where that split is
  uneven; a pool reads the extra end windows by ``ceil_mode``.  Max pools
  pad with ``-inf``; average pools divide by ``k * k`` whatever the padding,
  as the reference's ``reduce_window`` sum does.
* **Weights** are drawn on the CPU from a ``torch.Generator`` seeded by
  ``build``'s ``seed`` (``normal * sqrt(2 / (k * k * cin))``, zero biases),
  then moved to the device: a CPU build and a card build of one seed hold
  the same weights, and a net's weights do not depend on what was built
  before it.  A ``meta`` build draws nothing.
* **Tracing.** ``LayerGraph.trace()`` runs the graph on ``meta`` tensors
  while the weights live on the device: a module given a ``meta`` input
  uses ``meta`` stand-ins of its weights (:func:`_params`), one attribute
  test per call and no copy.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..core.graph import LayerGraph, LayerNode, TensorSpec


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis: ``(lo, hi)`` with
    ``hi - lo`` in {0, 1}."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as NCHW: a view with channels_last strides."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def _params(module: nn.Module, x: torch.Tensor):
    """The module's weight and bias, or ``meta`` stand-ins of them when the
    graph is traced (``x`` on ``meta``)."""
    if x.is_meta:
        return module.weight.to("meta"), module.bias.to("meta")
    return module.weight, module.bias


class Conv(nn.Module):
    """2-D convolution over NHWC (depthwise with ``groups == cin``), then
    ``act`` (``"relu"``, ``"relu6"`` or None)."""

    def __init__(self, weight: nn.Parameter, bias: nn.Parameter, k: int,
                 stride: int, padding: str, groups: int, act: str | None):
        super().__init__()
        self.weight, self.bias = weight, bias
        self.k, self.stride, self.padding = k, stride, padding
        self.groups, self.act = groups, act

    def forward(self, x):
        w, b = _params(self, x)
        pad = (0, 0)
        if self.padding == "SAME":
            (t, bo), (lf, r) = (same_pads(n, self.k, self.stride)
                                for n in x.shape[1:3])
            if (t, lf) == (bo, r):
                pad = (t, lf)
            else:                       # uneven: pad H and W of the NHWC
                x = F.pad(x, (0, 0, lf, r, t, bo))
        y = F.conv2d(_nchw(x), w, b, self.stride, pad, 1, self.groups)
        if self.act == "relu":
            y = y.relu_()
        elif self.act == "relu6":
            y = y.clamp_(0, 6)
        return _nhwc(y)


class Pool(nn.Module):
    """Max or average pooling over NHWC."""

    def __init__(self, k: int, stride: int, kind: str, padding: str):
        super().__init__()
        self.k, self.stride, self.kind, self.padding = k, stride, kind, padding

    def forward(self, x):
        k, s = self.k, self.stride
        pad, ceil = (0, 0), False
        if self.padding == "SAME":
            (t, bo), (lf, r) = (same_pads(n, k, s) for n in x.shape[1:3])
            if bo - t < s and r - lf < s:
                # the end's extra row/column: the windows ceil_mode adds
                pad, ceil = (t, lf), (bo, r) != (t, lf)
            else:
                fill = -math.inf if self.kind == "max" else 0.0
                x = F.pad(x, (0, 0, lf, r, t, bo), value=fill)
        x = _nchw(x)
        if self.kind == "max":
            y = F.max_pool2d(x, k, s, pad, ceil_mode=ceil)
        else:
            y = F.avg_pool2d(x, k, s, pad, ceil_mode=ceil,
                             divisor_override=k * k)
        return _nhwc(y)


class GlobalAvgPool(nn.Module):
    def forward(self, x):
        return x.mean(dim=(1, 2))


class Dense(nn.Module):
    """``x @ weight.T + bias`` over the last axis, then ``act`` (``"relu"``,
    ``"softmax"`` or None).  ``weight`` is ``(cout, cin)``."""

    def __init__(self, weight: nn.Parameter, bias: nn.Parameter,
                 act: str | None):
        super().__init__()
        self.weight, self.bias, self.act = weight, bias, act

    def forward(self, x):
        w, b = _params(self, x)
        y = F.linear(x, w, b)
        if self.act == "relu":
            y = y.relu_()
        elif self.act == "softmax":
            y = torch.softmax(y, dim=-1)
        return y


class Flatten(nn.Module):
    """NHWC to (B, H * W * C), in the reference's H, W, C order."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Add(nn.Module):
    def forward(self, *xs):
        y = xs[0]
        for x in xs[1:]:
            y = y + x
        return y


class Concat(nn.Module):
    """Concatenation on the channel axis (the last, in NHWC)."""

    def forward(self, *xs):
        return torch.cat(xs, dim=-1)


class ZooGraph(LayerGraph):
    """A :class:`LayerGraph` whose layers are modules, kept by node name in
    ``modules``.  The constructors below create a layer's module (drawing
    its weights in creation order) and return its node for :meth:`add`."""

    def __init__(self, name: str, device: torch.device, seed: int):
        super().__init__(name)
        self.device = device
        self.modules = nn.ModuleDict()
        self._gen = torch.Generator().manual_seed(seed)

    def _param(self, shape: tuple[int, ...], std: float) -> nn.Parameter:
        if self.device.type == "meta":
            t = torch.empty(shape, device="meta")
        elif std:
            t = torch.randn(shape, generator=self._gen) * std
        else:
            t = torch.zeros(shape)
        fmt = torch.channels_last if len(shape) == 4 else \
            torch.contiguous_format
        return nn.Parameter(t.to(self.device, memory_format=fmt),
                            requires_grad=False)

    def _node(self, name: str, kind: str, module: nn.Module,
              **kw) -> LayerNode:
        self.modules[name] = module
        return LayerNode(name=name, kind=kind, apply=module.forward, **kw)

    def conv(self, name, cin, cout, k=3, stride=1, padding="SAME", groups=1,
             act="relu") -> LayerNode:
        w = self._param((cout, cin // groups, k, k),
                        math.sqrt(2.0 / (k * k * cin)))
        b = self._param((cout,), 0.0)

        def flops_fn(ins, out):
            # 2 * k*k * (cin/groups) * spatial_out * cout * batch
            return 2.0 * k * k * (cin // groups) * math.prod(out.shape)

        return self._node(name, "conv",
                          Conv(w, b, k, stride, padding, groups, act),
                          flops_fn=flops_fn,
                          param_bytes=k * k * (cin // groups) * cout * 4
                          + cout * 4)

    def dw_conv(self, name, c, k=3, stride=1, act="relu6") -> LayerNode:
        return self.conv(name, c, c, k=k, stride=stride, groups=c, act=act)

    def pool(self, name, k=2, stride=2, kind="max", padding="VALID"
             ) -> LayerNode:
        return self._node(name, "pool", Pool(k, stride, kind, padding))

    def gap(self, name="gap") -> LayerNode:
        return self._node(name, "pool", GlobalAvgPool())

    def dense(self, name, cin, cout, act=None) -> LayerNode:
        w = self._param((cout, cin), math.sqrt(2.0 / cin))
        b = self._param((cout,), 0.0)
        return self._node(name, "dense", Dense(w, b, act),
                          flops_fn=lambda ins, out: 2.0 * cin * cout
                          * (math.prod(out.shape) // cout),
                          param_bytes=(cin + 1) * cout * 4)

    def flatten(self, name="flatten") -> LayerNode:
        return self._node(name, "reshape", Flatten())

    def sum(self, name="add") -> LayerNode:
        return self._node(name, "merge", Add())

    def concat(self, name="concat") -> LayerNode:
        return self._node(name, "merge", Concat())

    def image_input(self, res: int) -> int:
        return self.input(TensorSpec((1, res, res, 3), torch.float32))


# ---------------------------------------------------------------------------
# VGG (linear)
# ---------------------------------------------------------------------------

def _vgg(name: str, cfg: list, device, seed) -> ZooGraph:
    g = ZooGraph(name, device, seed)
    prev = g.image_input(224)
    cin = 3
    bi = 0
    for item in cfg:
        if item == "M":
            prev = g.add(g.pool(f"pool{bi}"), [prev])
            bi += 1
        else:
            prev = g.add(g.conv(f"conv{bi}", cin, item), [prev])
            cin = item
            bi += 1
    prev = g.add(g.flatten(), [prev])
    prev = g.add(g.dense("fc1", cin * 7 * 7, 4096, act="relu"), [prev])
    prev = g.add(g.dense("fc2", 4096, 4096, act="relu"), [prev])
    prev = g.add(g.dense("pred", 4096, 1000, act="softmax"), [prev])
    g.trace()
    return g


def vgg16(device, seed):
    return _vgg("VGG16", [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                          512, 512, 512, "M", 512, 512, 512, "M"],
                device, seed)


def vgg19(device, seed):
    return _vgg("VGG19", [64, 64, "M", 128, 128, "M", 256, 256, 256, 256,
                          "M", 512, 512, 512, 512, "M", 512, 512, 512, 512,
                          "M"], device, seed)


# ---------------------------------------------------------------------------
# ResNet v1 / v2 (branching; the reference builds both alike)
# ---------------------------------------------------------------------------

def _resnet(name: str, blocks_per_stage: list[int], device, seed
            ) -> ZooGraph:
    g = ZooGraph(name, device, seed)
    prev = g.image_input(224)
    prev = g.add(g.conv("stem_conv", 3, 64, k=7, stride=2), [prev])
    prev = g.add(g.pool("stem_pool", k=3, stride=2, padding="SAME"), [prev])
    cin = 64
    widths = [64, 128, 256, 512]
    for si, (n_blocks, w) in enumerate(zip(blocks_per_stage, widths)):
        for bi in range(n_blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            cout = w * 4
            tag = f"s{si}b{bi}"
            # main path: 1x1 -> 3x3 -> 1x1
            a = g.add(g.conv(f"{tag}_c1", cin, w, k=1, stride=stride), [prev])
            b = g.add(g.conv(f"{tag}_c2", w, w, k=3), [a])
            c = g.add(g.conv(f"{tag}_c3", w, cout, k=1, act=None), [b])
            if cin != cout or stride != 1:
                sc = g.add(g.conv(f"{tag}_sc", cin, cout, k=1, stride=stride,
                                  act=None), [prev])
            else:
                sc = prev
            prev = g.add(g.sum(f"{tag}_add"), [c, sc])
            cin = cout
    prev = g.add(g.gap(), [prev])
    prev = g.add(g.dense("pred", cin, 1000, act="softmax"), [prev])
    g.trace()
    return g


def resnet50(device, seed):
    return _resnet("ResNet50", [3, 4, 6, 3], device, seed)


def resnet101(device, seed):
    return _resnet("ResNet101", [3, 4, 23, 3], device, seed)


def resnet152(device, seed):
    return _resnet("ResNet152", [3, 8, 36, 3], device, seed)


def resnet50v2(device, seed):
    return _resnet("ResNet50V2", [3, 4, 6, 3], device, seed)


def resnet101v2(device, seed):
    return _resnet("ResNet101V2", [3, 4, 23, 3], device, seed)


def resnet152v2(device, seed):
    return _resnet("ResNet152V2", [3, 8, 36, 3], device, seed)


# ---------------------------------------------------------------------------
# MobileNet v1 (linear) / v2 (branching)
# ---------------------------------------------------------------------------

def mobilenet(device, seed) -> ZooGraph:
    g = ZooGraph("MobileNet", device, seed)
    prev = g.image_input(224)
    prev = g.add(g.conv("stem", 3, 32, stride=2, act="relu6"), [prev])
    cin = 32
    plan = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
            *[(512, 1)] * 5, (1024, 2), (1024, 1)]
    for i, (cout, s) in enumerate(plan):
        prev = g.add(g.dw_conv(f"dw{i}", cin, stride=s), [prev])
        prev = g.add(g.conv(f"pw{i}", cin, cout, k=1, act="relu6"), [prev])
        cin = cout
    prev = g.add(g.gap(), [prev])
    prev = g.add(g.dense("pred", cin, 1000, act="softmax"), [prev])
    g.trace()
    return g


def mobilenetv2(device, seed) -> ZooGraph:
    g = ZooGraph("MobileNetV2", device, seed)
    prev = g.image_input(224)
    prev = g.add(g.conv("stem", 3, 32, stride=2, act="relu6"), [prev])
    cin = 32
    # (expansion, out, n, stride)
    plan = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    idx = 0
    for t, c, n, s in plan:
        for bi in range(n):
            stride = s if bi == 0 else 1
            tag = f"b{idx}"
            mid = cin * t
            a = prev
            if t != 1:
                a = g.add(g.conv(f"{tag}_exp", cin, mid, k=1, act="relu6"),
                          [a])
            a = g.add(g.dw_conv(f"{tag}_dw", mid, stride=stride), [a])
            a = g.add(g.conv(f"{tag}_proj", mid, c, k=1, act=None), [a])
            if stride == 1 and cin == c:
                prev = g.add(g.sum(f"{tag}_add"), [a, prev])
            else:
                prev = a
            cin = c
            idx += 1
    prev = g.add(g.conv("head", cin, 1280, k=1, act="relu6"), [prev])
    prev = g.add(g.gap(), [prev])
    prev = g.add(g.dense("pred", 1280, 1000, act="softmax"), [prev])
    g.trace()
    return g


# ---------------------------------------------------------------------------
# DenseNet (branching: dense blocks fuse)
# ---------------------------------------------------------------------------

def _densenet(name: str, blocks: list[int], device, seed,
              growth: int = 32) -> ZooGraph:
    g = ZooGraph(name, device, seed)
    prev = g.image_input(224)
    prev = g.add(g.conv("stem", 3, 64, k=7, stride=2), [prev])
    prev = g.add(g.pool("stem_pool", k=3, stride=2, padding="SAME"), [prev])
    cin = 64
    for si, n in enumerate(blocks):
        for bi in range(n):
            tag = f"d{si}b{bi}"
            a = g.add(g.conv(f"{tag}_bn1", cin, 4 * growth, k=1), [prev])
            a = g.add(g.conv(f"{tag}_conv", 4 * growth, growth, k=3), [a])
            prev = g.add(g.concat(f"{tag}_cat"), [prev, a])
            cin += growth
        if si < len(blocks) - 1:
            cin //= 2
            prev = g.add(g.conv(f"t{si}_conv", cin * 2, cin, k=1), [prev])
            prev = g.add(g.pool(f"t{si}_pool", kind="avg"), [prev])
    prev = g.add(g.gap(), [prev])
    prev = g.add(g.dense("pred", cin, 1000, act="softmax"), [prev])
    g.trace()
    return g


def densenet121(device, seed):
    return _densenet("DenseNet121", [6, 12, 24, 16], device, seed)


def densenet169(device, seed):
    return _densenet("DenseNet169", [6, 12, 32, 32], device, seed)


def densenet201(device, seed):
    return _densenet("DenseNet201", [6, 12, 48, 32], device, seed)


# ---------------------------------------------------------------------------
# Inception V3 (branching)
# ---------------------------------------------------------------------------

def _inception_block(g, prev, cin, tag, widths):
    """4 parallel towers concatenated (simplified InceptionV3 cell)."""
    w1, w5, w3, wp = widths
    t1 = g.add(g.conv(f"{tag}_1x1", cin, w1, k=1), [prev])
    t5a = g.add(g.conv(f"{tag}_5r", cin, w5 // 2, k=1), [prev])
    t5 = g.add(g.conv(f"{tag}_5x5", w5 // 2, w5, k=5), [t5a])
    t3a = g.add(g.conv(f"{tag}_3r", cin, w3 // 2, k=1), [prev])
    t3b = g.add(g.conv(f"{tag}_3x3a", w3 // 2, w3, k=3), [t3a])
    t3 = g.add(g.conv(f"{tag}_3x3b", w3, w3, k=3), [t3b])
    tp1 = g.add(g.pool(f"{tag}_pool", k=3, stride=1, kind="avg",
                       padding="SAME"), [prev])
    tp = g.add(g.conv(f"{tag}_poolproj", cin, wp, k=1), [tp1])
    out = g.add(g.concat(f"{tag}_cat"), [t1, t5, t3, tp])
    return out, w1 + w5 + w3 + wp


def inceptionv3(device, seed) -> ZooGraph:
    g = ZooGraph("InceptionV3", device, seed)
    prev = g.image_input(299)
    prev = g.add(g.conv("stem1", 3, 32, stride=2, padding="VALID"), [prev])
    prev = g.add(g.conv("stem2", 32, 64, k=3), [prev])
    prev = g.add(g.pool("stem_pool", k=3, stride=2), [prev])
    prev = g.add(g.conv("stem3", 64, 80, k=1), [prev])
    prev = g.add(g.conv("stem4", 80, 192, k=3, stride=2), [prev])
    cin = 192
    for i, widths in enumerate([(64, 64, 96, 32), (64, 64, 96, 64),
                                (64, 64, 96, 64)]):
        prev, cin = _inception_block(g, prev, cin, f"mix{i}", widths)
    prev = g.add(g.pool("red0", k=3, stride=2), [prev])
    for i, widths in enumerate([(192, 128, 128, 192)] * 4):
        prev, cin = _inception_block(g, prev, cin, f"mid{i}", widths)
    prev = g.add(g.pool("red1", k=3, stride=2), [prev])
    for i, widths in enumerate([(320, 192, 192, 192)] * 2):
        prev, cin = _inception_block(g, prev, cin, f"top{i}", widths)
    prev = g.add(g.gap(), [prev])
    prev = g.add(g.dense("pred", cin, 1000, act="softmax"), [prev])
    g.trace()
    return g


# ---------------------------------------------------------------------------
# Xception (branching, depthwise separable + residuals)
# ---------------------------------------------------------------------------

def xception(device, seed) -> ZooGraph:
    g = ZooGraph("Xception", device, seed)
    prev = g.image_input(299)
    prev = g.add(g.conv("stem1", 3, 32, stride=2), [prev])
    prev = g.add(g.conv("stem2", 32, 64), [prev])
    cin = 64
    for i, cout in enumerate([128, 256, 728]):
        tag = f"entry{i}"
        a = g.add(g.dw_conv(f"{tag}_dw1", cin), [prev])
        a = g.add(g.conv(f"{tag}_pw1", cin, cout, k=1), [a])
        a = g.add(g.dw_conv(f"{tag}_dw2", cout), [a])
        a = g.add(g.conv(f"{tag}_pw2", cout, cout, k=1, act=None), [a])
        a = g.add(g.pool(f"{tag}_pool", k=3, stride=2, padding="SAME"), [a])
        sc = g.add(g.conv(f"{tag}_sc", cin, cout, k=1, stride=2, act=None),
                   [prev])
        prev = g.add(g.sum(f"{tag}_add"), [a, sc])
        cin = cout
    for i in range(8):
        tag = f"mid{i}"
        a = g.add(g.dw_conv(f"{tag}_dw1", cin), [prev])
        a = g.add(g.conv(f"{tag}_pw1", cin, cin, k=1), [a])
        a = g.add(g.dw_conv(f"{tag}_dw2", cin), [a])
        a = g.add(g.conv(f"{tag}_pw2", cin, cin, k=1, act=None), [a])
        prev = g.add(g.sum(f"{tag}_add"), [a, prev])
    prev = g.add(g.conv("exit1", cin, 1024, k=1), [prev])
    prev = g.add(g.gap(), [prev])
    prev = g.add(g.dense("pred", 1024, 1000, act="softmax"), [prev])
    g.trace()
    return g


# ---------------------------------------------------------------------------
# InceptionResNetV2 / NASNet — structurally faithful approximations
# ---------------------------------------------------------------------------

def inception_resnet_v2(device, seed) -> ZooGraph:
    """approx: correct cell counts (5×A, 10×B, 5×C) and widths."""
    g = ZooGraph("InceptionResNetV2", device, seed)
    prev = g.image_input(299)
    prev = g.add(g.conv("stem1", 3, 32, stride=2, padding="VALID"), [prev])
    prev = g.add(g.conv("stem2", 32, 64, k=3), [prev])
    prev = g.add(g.pool("stem_pool", k=3, stride=2), [prev])
    prev = g.add(g.conv("stem3", 64, 192, k=3, stride=2), [prev])
    prev = g.add(g.conv("stem4", 192, 320, k=1), [prev])
    cin = 320
    for phase, (n, width) in enumerate([(5, 320), (10, 1088), (5, 2080)]):
        if phase > 0:
            prev = g.add(g.conv(f"red{phase}", cin, width, k=3, stride=2),
                         [prev])
            cin = width
        for i in range(n):
            tag = f"irb{phase}_{i}"
            a = g.add(g.conv(f"{tag}_b1", cin, 32, k=1), [prev])
            b1 = g.add(g.conv(f"{tag}_b2a", cin, 32, k=1), [prev])
            b = g.add(g.conv(f"{tag}_b2b", 32, 48, k=3), [b1])
            cat = g.add(g.concat(f"{tag}_cat"), [a, b])
            proj = g.add(g.conv(f"{tag}_proj", 80, cin, k=1, act=None),
                         [cat])
            prev = g.add(g.sum(f"{tag}_add"), [proj, prev])
    prev = g.add(g.gap(), [prev])
    prev = g.add(g.dense("pred", cin, 1000, act="softmax"), [prev])
    g.trace()
    return g


def _nasnet(name: str, n_cells: int, width: int, device, seed,
            res: int = 224) -> ZooGraph:
    """approx: NASNet normal cells as 5-branch concat cells; the partition
    -point structure (cuts only between reduction stages) matches Table I."""
    g = ZooGraph(name, device, seed)
    prev = g.image_input(res)
    prev = g.add(g.conv("stem", 3, width, k=3, stride=2), [prev])
    cin = width
    per_stage = n_cells // 3
    for stage in range(3):
        if stage > 0:
            prev = g.add(g.conv(f"red{stage}", cin, cin * 2, k=3, stride=2),
                         [prev])
            cin *= 2
        # cells within a stage cross-link (use both of the previous two
        # outputs), so cuts inside a stage are invalid, like real NASNet
        prev2 = prev
        for ci in range(per_stage):
            tag = f"s{stage}c{ci}"
            b1 = g.add(g.dw_conv(f"{tag}_dw3", cin), [prev])
            b1 = g.add(g.conv(f"{tag}_pw1", cin, cin // 2, k=1), [b1])
            b2 = g.add(g.dw_conv(f"{tag}_dw5", cin, k=5), [prev2])
            b2 = g.add(g.conv(f"{tag}_pw2", cin, cin // 2, k=1), [b2])
            cat = g.add(g.concat(f"{tag}_cat"), [b1, b2])
            new = g.add(g.conv(f"{tag}_fit", cin, cin, k=1), [cat])
            prev2, prev = prev, new
        # close the stage: merge the dangling prev2 so the stage boundary
        # becomes a valid cut
        if per_stage > 0:
            prev = g.add(g.sum(f"s{stage}_merge"), [prev, prev2])
    prev = g.add(g.gap(), [prev])
    prev = g.add(g.dense("pred", cin, 1000, act="softmax"), [prev])
    g.trace()
    return g


def nasnet_mobile(device, seed):
    return _nasnet("NASNetMobile", 12, 44, device, seed)


def nasnet_large(device, seed):
    return _nasnet("NASNetLarge", 18, 168, device, seed, res=331)


# ---------------------------------------------------------------------------

ZOO = {
    "Xception": xception,
    "VGG16": vgg16,
    "VGG19": vgg19,
    "ResNet50": resnet50,
    "ResNet101": resnet101,
    "ResNet152": resnet152,
    "ResNet50V2": resnet50v2,
    "ResNet101V2": resnet101v2,
    "ResNet152V2": resnet152v2,
    "InceptionV3": inceptionv3,
    "InceptionResNetV2": inception_resnet_v2,
    "MobileNet": mobilenet,
    "MobileNetV2": mobilenetv2,
    "DenseNet121": densenet121,
    "DenseNet169": densenet169,
    "DenseNet201": densenet201,
    "NASNetMobile": nasnet_mobile,
    "NASNetLarge": nasnet_large,
}

APPROX = {"InceptionResNetV2", "NASNetMobile", "NASNetLarge"}

# Table I linear/branching classification
LINEAR = {"VGG16", "VGG19", "MobileNet"}


def build(name: str, device: str | torch.device = "cuda",
          seed: int = 0) -> ZooGraph:
    """Zoo net ``name`` with weights from ``seed`` on ``device`` (``"meta"``
    for structure alone), traced."""
    return ZOO[name](resolve_device(device), seed)


def load_params(graph: ZooGraph, params: dict[str, torch.Tensor]) -> None:
    """Copy a state dict (``"<node>.weight"``, ``"<node>.bias"``, e.g. from
    :func:`repro_torch.convert.zoo_params_to_torch`) into the graph's
    modules; every parameter must be given."""
    graph.modules.load_state_dict(params, strict=True)
