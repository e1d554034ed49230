"""ResNet family (counterpart of the reference's
``vision/models/resnet.py``): config #2's model.

The public contract is NCHW and the parameter and buffer names are the
reference's (``conv1.weight``, ``bn1._mean``, ``layer1.0.downsample.1.
_variance``, ...), so ``convert.load_reference_params`` carries a
reference model across.  ``data_format="NHWC"`` runs the stack
channels-last: the input is transposed once at entry into channels-last
memory (every later conv, BatchNorm and pool then sees a channels-last
tensor, which cuDNN takes as NHWC) and back to NCHW before the flatten.
The weights are OIHW in both formats.  ``space_to_depth_stem`` (NHWC
only) computes the 7x7/s2 stem as a 4x4/s1 conv over pixels grouped by
parity; the canonical 7x7 weight stays the parameter, scattered into the
4x4 kernel inside autograd so its gradient reaches it.  The scatter is
the op ``s2d_stem``, white under ``amp.auto_cast`` as the reference's.

Constructors take ``device=None`` (``cuda``) and ``seed=0``: the weights
are drawn in construction order from a ``torch.Generator`` seeded with
it.  ``pretrained=True`` raises: no weights are bundled.
"""
from __future__ import annotations

import functools
from typing import List, Optional

import torch
import torch.nn.functional as tF
from torch import nn as tnn

from ... import nn
from ...core.device import resolve_device
from ...framework.dispatch import make_op as _make_op
from ...tensor import flatten, transpose

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "wide_resnet50_2", "wide_resnet101_2"]


class BasicBlock(tnn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", device=None, generator=None):
        super().__init__()
        norm_layer = norm_layer or functools.partial(
            nn.BatchNorm2D, data_format=data_format, device=device)
        if groups != 1 or base_width != 64:
            raise ValueError(
                "BasicBlock only supports groups=1, base_width=64")
        kw = dict(bias_attr=False, data_format=data_format, device=device,
                  generator=generator)
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride,
                               padding=1, **kw)
        self.bn1 = norm_layer(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, **kw)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(tnn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", device=None, generator=None):
        super().__init__()
        norm_layer = norm_layer or functools.partial(
            nn.BatchNorm2D, data_format=data_format, device=device)
        width = int(planes * (base_width / 64.0)) * groups
        kw = dict(bias_attr=False, data_format=data_format, device=device,
                  generator=generator)
        self.conv1 = nn.Conv2D(inplanes, width, 1, **kw)
        self.bn1 = norm_layer(width)
        self.conv2 = nn.Conv2D(width, width, 3, stride=stride,
                               padding=dilation, groups=groups,
                               dilation=dilation, **kw)
        self.bn2 = norm_layer(width)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1, **kw)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


def _space_to_depth_stem(x_nhwc, w_oihw):
    """The 7x7/s2/pad-3 stem conv as a 4x4/s1 conv.

    Input pixels are regrouped by parity -- [N, H, W, C] -> [N, H/2, W/2,
    4C] -- and the 7x7 kernel scattered into an equivalent 4x4 one over
    those channels: tap ``kh`` reads input row ``2 * ho + kh - 3``, of
    parity ``(kh + 1) % 2`` at s2d row offset ``(kh + 1) // 2 - 2``, a
    4-tap window padded (2, 1); the same in w.  Each output sums the same
    products as the 7x7 conv (in another order).  The result is NHWC."""
    if w_oihw.dtype != x_nhwc.dtype:
        w_oihw = w_oihw.to(x_nhwc.dtype)
    block = 2  # the derivation is fixed to the 7x7/stride-2/pad-3 stem
    n, h, w, ci = x_nhwc.shape
    co, k = w_oihw.shape[0], w_oihw.shape[2]
    x2 = x_nhwc.reshape(n, h // block, block, w // block, block, ci)
    x2 = x2.permute(0, 1, 3, 2, 4, 5).reshape(
        n, h // block, w // block, block * block * ci)
    w_hwio = w_oihw.permute(2, 3, 1, 0)  # [7, 7, ci, co]
    kh = torch.arange(k, device=w_oihw.device)
    d, p = (kh + 1) // 2, (kh + 1) % 2
    k2 = torch.zeros((4, 2, 4, 2, ci, co), dtype=w_oihw.dtype,
                     device=w_oihw.device).index_put(
        (d[:, None], p[:, None], d[None, :], p[None, :]), w_hwio)
    # [dh, ph, dw, pw, ci, co] -> OIHW over the (ph, pw, ci) channels
    k2 = k2.permute(0, 2, 1, 3, 4, 5).reshape(4, 4, block * block * ci, co)
    k2 = k2.permute(3, 2, 0, 1)
    out = tF.conv2d(tF.pad(x2.permute(0, 3, 1, 2), [2, 1, 2, 1]), k2)
    return out.permute(0, 2, 3, 1)


_s2d_op = _make_op(_space_to_depth_stem, "s2d_stem")


class ResNet(tnn.Module):
    """vision/models/resnet.py's ResNet: ``block`` (BasicBlock or
    BottleneckBlock), ``depth`` in 18/34/50/101/152 (or ``layers=``),
    ``data_format`` NCHW or NHWC, ``space_to_depth_stem`` NHWC only."""

    def __init__(self, block, depth: int = 50,
                 layers: Optional[List[int]] = None, num_classes: int = 1000,
                 with_pool: bool = True, groups: int = 1, width: int = 64,
                 data_format: str = "NCHW",
                 space_to_depth_stem: bool = False, device=None,
                 seed: int = 0):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        if layers is None and depth not in layer_cfg:
            raise ValueError(
                "ResNet depth must be one of %s (or pass layers=), got %r"
                % (sorted(layer_cfg), depth))
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError("data_format must be NCHW or NHWC, got %r"
                             % (data_format,))
        if space_to_depth_stem and data_format != "NHWC":
            raise ValueError(
                "space_to_depth_stem requires data_format='NHWC'")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        self._kw = dict(device=dev, generator=gen)
        self.space_to_depth_stem = bool(space_to_depth_stem)
        layers = layers or layer_cfg[depth]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.groups = groups
        self.base_width = width
        self.data_format = data_format
        self._norm_layer = functools.partial(
            nn.BatchNorm2D, data_format=data_format, device=dev)
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                               bias_attr=False, data_format=data_format,
                               **self._kw)
        self.bn1 = self._norm_layer(self.inplanes)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1,
                                    data_format=data_format)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1),
                                                data_format=data_format)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes,
                                **self._kw)
        del self._kw  # the generator is for construction only

    def _make_layer(self, block, planes, blocks, stride=1):
        norm_layer = self._norm_layer
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False,
                          data_format=self.data_format, **self._kw),
                norm_layer(planes * block.expansion),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, 1, norm_layer,
                        data_format=self.data_format, **self._kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer,
                                data_format=self.data_format, **self._kw))
        return nn.Sequential(*layers)

    def forward(self, x):
        if self.data_format == "NHWC":
            # the public contract stays NCHW; one transpose at entry, into
            # channels-last memory, puts the whole stack channels-last
            x = transpose(x, [0, 2, 3, 1]).contiguous()
        # the s2d rewrite needs even spatial dims (parity grouping) and the
        # canonical 7x7 stem; anything else takes the plain conv
        if self.space_to_depth_stem and x.shape[1] % 2 == 0 \
                and x.shape[2] % 2 == 0 \
                and self.conv1.weight.shape[-1] == 7:
            x = self.relu(self.bn1(_s2d_op(x, self.conv1.weight)))
        else:
            x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.data_format == "NHWC":
            # NCHW again before the flatten, so feature-extractor outputs
            # and fc weights do not depend on the layout
            x = transpose(x, [0, 3, 1, 2])
        if self.num_classes > 0:
            x = flatten(x, 1)
            x = self.fc(x)
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled; load a checkpoint with "
            "load_state_dict (or convert.load_reference_params) instead")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)
