"""Early-convolution tokenizer (counterpart of ``m3l_tpu/nn/early_cnn.py``).

Three strided 4x4 convs (the third is 3x3/stride 1 for the tactile tower, so a 32x32 tactile
map and a 64x64 image both give an 8x8 = 64-token grid) and a 1x1 projection to the encoder
width; ReLU after convs 1-3. NHWC at the interface, NCHW inside; tokens come out row-major over
the output grid (``flatten(2).transpose(1, 2)`` of NCHW).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d


class EarlyCNN(nn.Module):
    def __init__(self, in_channels: int, encoder_dim: int, *, kind: str = "image", dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_channels, encoder_dim // 8, 4, stride=2, padding=1, dtype=dtype)
        self.conv2 = Conv2d(encoder_dim // 8, encoder_dim // 4, 4, stride=2, padding=1, dtype=dtype)
        if kind == "image":
            self.conv3 = Conv2d(encoder_dim // 4, encoder_dim // 2, 4, stride=2, padding=1, dtype=dtype)
        else:
            self.conv3 = Conv2d(encoder_dim // 4, encoder_dim // 2, 3, stride=1, padding=1, dtype=dtype)
        self.conv4 = Conv2d(encoder_dim // 2, encoder_dim, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, tokens, encoder_dim)."""
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        x = F.relu(self.conv3(x))
        return self.conv4(x).flatten(2).transpose(1, 2)
