"""CIFAR-10 ResNet family (torch; copy of dacapo_tpu/models/resnet.py).

Mirrors the reference model zoo (python/poly/poly/models/ResNet.py:27-95):
BasicBlock with option-A shortcuts (stride-2 subsample + zero channel pad,
which MPCB implements as Downsamp/HE_DS) and SiLU activations. `get_model`
loads the reference's trained checkpoint (examples/data/resnet20.silu.model);
`randomize()` gives deterministic random weights for tests.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["ResNet", "BasicBlock", "resnet20", "resnet32", "resnet44",
           "resnet56", "resnet110", "randomize", "get_model"]


class LambdaLayer(nn.Module):
    def __init__(self, lambd):
        super().__init__()
        self.lambd = lambd

    def forward(self, x):
        return self.lambd(x)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes, planes, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride,
                               padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=1, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.mish = nn.SiLU()
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes:
            # option A: stride-2 spatial subsample + zero channel padding
            self.shortcut = LambdaLayer(
                lambda x: F.pad(x[:, :, ::2, ::2],
                                (0, 0, 0, 0, planes // 4, planes // 4)))

    def forward(self, x):
        out = self.mish(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        out = out + self.shortcut(x)
        return self.mish(out)


class ResNet(nn.Module):
    def __init__(self, block, num_blocks, num_classes=10):
        super().__init__()
        self.in_planes = 16
        self.conv1 = nn.Conv2d(3, 16, 3, stride=1, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(16)
        self.layer1 = self._make_layer(block, 16, num_blocks[0], 1)
        self.layer2 = self._make_layer(block, 32, num_blocks[1], 2)
        self.layer3 = self._make_layer(block, 64, num_blocks[2], 2)
        self.linear = nn.Linear(64, num_classes)
        self.mish = nn.SiLU()

    def _make_layer(self, block, planes, n, stride):
        layers = []
        for s in [stride] + [1] * (n - 1):
            layers.append(block(self.in_planes, planes, s))
            self.in_planes = planes * block.expansion
        return nn.Sequential(*layers)

    def forward(self, x):
        out = self.mish(self.bn1(self.conv1(x)))
        out = self.layer1(out)
        out = self.layer2(out)
        out = self.layer3(out)
        out = F.avg_pool2d(out, out.size(3))
        return self.linear(out.view(out.size(0), -1))


def resnet20():
    return ResNet(BasicBlock, [3, 3, 3])


def resnet32():
    return ResNet(BasicBlock, [5, 5, 5])


def resnet44():
    return ResNet(BasicBlock, [7, 7, 7])


def resnet56():
    return ResNet(BasicBlock, [9, 9, 9])


def resnet110():
    return ResNet(BasicBlock, [18, 18, 18])


def randomize(model: nn.Module, seed=0, calib_shape=(3, 32, 32),
              calib_batch=64) -> nn.Module:
    """Deterministic random weights + *calibrated* BN running stats.

    A calibration batch is forwarded in train mode (momentum=1) so running
    stats equal real batch statistics — like a trained net, BN keeps
    activations bounded, which the HE path needs (|x| <= bb for the
    polynomial activations) and which exercises the BN folding
    (MPCB abstractBN) with non-trivial values.
    """
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            nn.init.kaiming_normal_(m.weight, generator=g)
            if m.bias is not None:
                nn.init.normal_(m.bias, 0.0, 0.05, generator=g)
        elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm1d)):
            c = m.num_features
            dt = m.weight.dtype
            m.weight.data = (0.7 + 0.6 * torch.rand(c, generator=g)).to(dt)
            m.bias.data = (0.2 * torch.randn(c, generator=g)).to(dt)
            m.momentum = 1.0
    if calib_shape is not None:
        dtype = next(model.parameters()).dtype
        model.train()
        with torch.no_grad():
            model(torch.randn(calib_batch, *calib_shape,
                              generator=g).to(dtype))
    return model.eval()


def get_model(ckpt_path):
    """ResNet-20 with the trained checkpoint at `ckpt_path` (a torch
    `{"state_dict": ...}` file such as examples/data/resnet20.silu.model),
    as examples/benchmarks/ResNet.py:get_model loads it: the DataParallel
    `module.` prefix stripped, then double precision, eval mode."""
    m = resnet20()
    sd = torch.load(ckpt_path, map_location="cpu")["state_dict"]
    m.load_state_dict({k.removeprefix("module."): v for k, v in sd.items()})
    return m.double().eval()
