"""Conv-net baseline encoders (counterpart of ``m3l_tpu/models/baselines.py``).

A ResNet-18 and an AlexNet-style encoder trained from scratch (no pretrained weights), each
emitting the probe heads' token sequence ((B, N, D) from the final feature map) and a pooled
feature vector. Inputs and outputs are NHWC, as in the JAX package; the convolutions run NCHW
inside.

* BatchNorm always normalises by its running statistics and never updates them, in train mode
  too (the JAX modules build ``nnx.BatchNorm(use_running_average=True)``): :class:`BatchNorm2d`.
* The ResNet stem's max pool is XLA's 3 x 3 / 2 "SAME" window: the input is padded with -inf by
  (total // 2, total - total // 2) per axis, which is (0, 1) on an even size, not
  ``nn.MaxPool2d(3, 2, padding=1)``'s (1, 1). AlexNet's pools are "VALID".
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import BatchNorm2d, Conv2d


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """``reduce_window(max, (1, 3, 3, 1), (1, 2, 2, 1), "SAME")`` of an NCHW ``x``: each spatial axis
    padded with -inf by (total // 2, total - total // 2)."""
    pads = []
    for n in reversed(x.shape[2:]):
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), 3, 2)


def _tokens(x: torch.Tensor) -> dict:
    """NCHW feature map -> the probe heads' dict of row-major tokens (B, H*W, C)."""
    tokens = x.flatten(2).transpose(1, 2)
    return {"x_norm_patchtokens": tokens, "x_norm_regtokens": tokens[:, :0], "x_prenorm": tokens, "masks": None}


class _ConvBNRelu(nn.Module):
    def __init__(self, cin, cout, k, s, p, *, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, s, p, bias=False, dtype=dtype)
        self.bn = BatchNorm2d(cout, dtype=dtype)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class _BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride, *, dtype=torch.float32):
        super().__init__()
        self.c1 = _ConvBNRelu(cin, cout, 3, stride, 1, dtype=dtype)
        self.conv2 = Conv2d(cout, cout, 3, 1, 1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(cout, dtype=dtype)
        self.down = _ConvBNRelu(cin, cout, 1, stride, 0, dtype=dtype) if (stride != 1 or cin != cout) else None

    def forward(self, x):
        h = self.bn2(self.conv2(self.c1(x)))
        skip = self.down(x) if self.down is not None else x
        return F.relu(h + skip)


class ResNet18Encoder(nn.Module):
    def __init__(self, in_chans: int = 3, *, dtype=torch.float32):
        super().__init__()
        self.stem = _ConvBNRelu(in_chans, 64, 7, 2, 3, dtype=dtype)
        widths = [64, 64, 128, 128, 256, 256, 512, 512]
        strides = [1, 1, 2, 1, 2, 1, 2, 1]
        cins = [64] + widths[:-1]
        self.blocks = nn.ModuleList([_BasicBlock(ci, co, s, dtype=dtype) for ci, co, s in zip(cins, widths, strides)])
        self.embed_dim = 512

    def _spatial(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool_same(self.stem(x.permute(0, 3, 1, 2)))
        for blk in self.blocks:
            x = blk(x)
        return x

    def forward_spatial(self, x: torch.Tensor) -> torch.Tensor:
        """The final feature map (B, H/32, W/32, 512) of an NHWC input."""
        return self._spatial(x).permute(0, 2, 3, 1)

    def forward_features(self, x: torch.Tensor) -> dict:
        return _tokens(self._spatial(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_features(x)["x_norm_patchtokens"].mean(dim=1)


class AlexNetEncoder(nn.Module):
    def __init__(self, in_chans: int = 3, *, dtype=torch.float32):
        super().__init__()
        self.c1 = Conv2d(in_chans, 64, 11, 4, 2, dtype=dtype)
        self.c2 = Conv2d(64, 192, 5, 1, 2, dtype=dtype)
        self.c3 = Conv2d(192, 384, 3, 1, 1, dtype=dtype)
        self.c4 = Conv2d(384, 256, 3, 1, 1, dtype=dtype)
        self.c5 = Conv2d(256, 256, 3, 1, 1, dtype=dtype)
        self.embed_dim = 256

    def forward_features(self, x: torch.Tensor) -> dict:
        x = F.max_pool2d(F.relu(self.c1(x.permute(0, 3, 1, 2))), 3, 2)
        x = F.max_pool2d(F.relu(self.c2(x)), 3, 2)
        x = F.relu(self.c3(x))
        x = F.relu(self.c4(x))
        x = F.max_pool2d(F.relu(self.c5(x)), 3, 2)
        return _tokens(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_features(x)["x_norm_patchtokens"].mean(dim=1)
