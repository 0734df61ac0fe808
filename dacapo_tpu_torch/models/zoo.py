"""Model zoo: AlexNet, LeNet, VGG16, SqueezeNet, MobileNet (torch defs).

Mirrors the reference model definitions (python/poly/poly/models/
{AlexNet,Lenet,VGG16,SqueezeNet,MobileNet}.py) with the same attribute names
so HE forward builders written against the reference port directly. Convs
followed by BN are bias-free (the HE path folds BN only; reference HE_ConvBN
drops conv bias). Weights come from resnet.randomize (calibrated BN stats).

A copy of dacapo_tpu/models/zoo.py.
"""

import torch
import torch.nn as nn

from .resnet import randomize  # re-export for weight init

__all__ = ["AlexNet", "LeNet", "VGG16", "SqueezeNet", "MobileNet",
           "alexnet", "lenet", "vgg16", "squeezenet", "mobilenet",
           "randomize"]


class Square(nn.Module):
    def forward(self, x):
        return torch.square(x)


# ---------------------------------------------------------------- AlexNet
class AlexNet(nn.Module):
    """CIFAR AlexNet: 5 ConvBN+SiLU stages, 3 stride-2 avg pools, 3 FCs
    (reference models/AlexNet.py:17-101)."""

    def __init__(self, num_classes=10):
        super().__init__()
        self.Conv2d_1 = nn.Conv2d(3, 96, 3, padding=1, bias=False)
        self.bn_1 = nn.BatchNorm2d(96)
        self.avgpool_1 = nn.AvgPool2d((3, 3), stride=2, padding=1)
        self.Conv2d_2 = nn.Conv2d(96, 256, 5, padding=2, bias=False)
        self.bn_2 = nn.BatchNorm2d(256)
        self.avgpool_2 = nn.AvgPool2d((3, 3), stride=2, padding=1)
        self.Conv2d_3 = nn.Conv2d(256, 384, 3, padding=1, bias=False)
        self.bn_3 = nn.BatchNorm2d(384)
        self.Conv2d_4 = nn.Conv2d(384, 384, 3, padding=1, bias=False)
        self.bn_4 = nn.BatchNorm2d(384)
        self.Conv2d_5 = nn.Conv2d(384, 256, 3, padding=1, bias=False)
        self.bn_5 = nn.BatchNorm2d(256)
        self.avgpool_3 = nn.AvgPool2d((3, 3), stride=2, padding=1)
        self.fc_1 = nn.Linear(4 * 4 * 256, 2048)
        self.fc_2 = nn.Linear(2048, 1024)
        self.fc_3 = nn.Linear(1024, num_classes)
        self.mish = nn.SiLU()

    def forward(self, x):
        x = self.avgpool_1(self.mish(self.bn_1(self.Conv2d_1(x))))
        x = self.avgpool_2(self.mish(self.bn_2(self.Conv2d_2(x))))
        x = self.mish(self.bn_3(self.Conv2d_3(x)))
        x = self.mish(self.bn_4(self.Conv2d_4(x)))
        x = self.mish(self.bn_5(self.Conv2d_5(x)))
        x = self.avgpool_3(x)
        x = x.view(x.size(0), -1)
        x = self.mish(self.fc_1(x))
        x = self.mish(self.fc_2(x))
        return self.fc_3(x)


# ------------------------------------------------------------------ LeNet
class LeNet(nn.Module):
    """LeNet-5-class CNN with square activations and avg pools (reference
    models/Lenet.py CNNClassifier; pads folded into conv padding)."""

    def __init__(self, num_classes=10):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 6, 5, padding=2, bias=False)   # 32->32
        self.bn1 = nn.BatchNorm2d(6)
        self.pool1 = nn.AvgPool2d(2, 2)                          # 32->16
        self.conv2 = nn.Conv2d(6, 16, 5, padding=2, bias=False)  # 16->16
        self.bn2 = nn.BatchNorm2d(16)
        self.pool2 = nn.AvgPool2d(2, 2)                          # 16->8
        self.fc1 = nn.Linear(16 * 8 * 8, 128, bias=False)
        self.bn3 = nn.BatchNorm1d(128)
        self.fc2 = nn.Linear(128, 64, bias=False)
        self.bn4 = nn.BatchNorm1d(64)
        self.fc3 = nn.Linear(64, 16, bias=False)
        self.bn5 = nn.BatchNorm1d(16)
        self.act = Square()

    def forward(self, x):
        x = self.pool1(self.act(self.bn1(self.conv1(x))))
        x = self.pool2(self.act(self.bn2(self.conv2(x))))
        x = x.view(x.size(0), -1)
        x = self.act(self.bn3(self.fc1(x)))
        x = self.act(self.bn4(self.fc2(x)))
        x = self.bn5(self.fc3(x))
        return x[:, :10]


# ------------------------------------------------------------------ VGG16
class BasicConv2d(nn.Module):
    def __init__(self, in_ch, out_ch, ksize, stride=1, padding=0):
        super().__init__()
        self.Conv2d = nn.Conv2d(in_ch, out_ch, ksize, stride=stride,
                                padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_ch)
        self.mish = nn.SiLU()

    def forward(self, x):
        return self.mish(self.bn(self.Conv2d(x)))


class VGG16(nn.Module):
    """CIFAR VGG16 with BN+SiLU conv blocks and 2x2 avg pools (reference
    models/VGG16.py:31-63)."""

    def __init__(self, num_classes=10):
        super().__init__()
        self.conv_1_1 = BasicConv2d(3, 64, 3, padding=1)
        self.conv_1_2 = BasicConv2d(64, 64, 3, padding=1)
        self.avgpool_1 = nn.AvgPool2d(2, 2)
        self.conv_2_1 = BasicConv2d(64, 128, 3, padding=1)
        self.conv_2_2 = BasicConv2d(128, 128, 3, padding=1)
        self.avgpool_2 = nn.AvgPool2d(2, 2)
        self.conv_3_1 = BasicConv2d(128, 256, 3, padding=1)
        self.conv_3_2 = BasicConv2d(256, 256, 3, padding=1)
        self.conv_3_3 = BasicConv2d(256, 256, 3, padding=1)
        self.avgpool_3 = nn.AvgPool2d(2, 2)
        self.conv_4_1 = BasicConv2d(256, 512, 3, padding=1)
        self.conv_4_2 = BasicConv2d(512, 512, 3, padding=1)
        self.conv_4_3 = BasicConv2d(512, 512, 3, padding=1)
        self.avgpool_4 = nn.AvgPool2d(2, 2)
        self.conv_5_1 = BasicConv2d(512, 512, 3, padding=1)
        self.conv_5_2 = BasicConv2d(512, 512, 3, padding=1)
        self.conv_5_3 = BasicConv2d(512, 512, 3, padding=1)
        self.avgpool_5 = nn.AvgPool2d(2, 2)
        self.fc_1 = nn.Linear(512, 256)
        self.fc_2 = nn.Linear(256, 128)
        self.bn_1 = nn.BatchNorm1d(128)
        self.fc_3 = nn.Linear(128, num_classes)
        self.mish = nn.SiLU()

    def forward(self, x):
        x = self.avgpool_1(self.conv_1_2(self.conv_1_1(x)))
        x = self.avgpool_2(self.conv_2_2(self.conv_2_1(x)))
        x = self.avgpool_3(self.conv_3_3(self.conv_3_2(self.conv_3_1(x))))
        x = self.avgpool_4(self.conv_4_3(self.conv_4_2(self.conv_4_1(x))))
        x = self.avgpool_5(self.conv_5_3(self.conv_5_2(self.conv_5_1(x))))
        x = x.view(x.size(0), -1)
        x = self.mish(self.fc_1(x))
        x = self.mish(self.bn_1(self.fc_2(x)))
        return self.fc_3(x)


# -------------------------------------------------------------- SqueezeNet
FIRE_CONFIG = {
    "fire2": dict(s1x1=16, e1x1=64, e3x3=64),
    "fire3": dict(s1x1=16, e1x1=64, e3x3=64),
    "fire4": dict(s1x1=32, e1x1=128, e3x3=128),
    "fire5": dict(s1x1=32, e1x1=128, e3x3=128),
    "fire6": dict(s1x1=48, e1x1=192, e3x3=192),
    "fire7": dict(s1x1=48, e1x1=192, e3x3=192),
    "fire8": dict(s1x1=64, e1x1=256, e3x3=256),
    "fire9": dict(s1x1=64, e1x1=256, e3x3=256),
}


class Fire(nn.Module):
    def __init__(self, in_ch, name):
        super().__init__()
        cfg = FIRE_CONFIG[name]
        self.squeeze = BasicConv2d(in_ch, cfg["s1x1"], 1)
        self.expand1x1 = nn.Conv2d(cfg["s1x1"], cfg["e1x1"], 1)
        self.expand3x3 = nn.Conv2d(cfg["s1x1"], cfg["e3x3"], 3, padding=1)

    def forward(self, x):
        x = self.squeeze(x)
        return torch.cat([self.expand1x1(x), self.expand3x3(x)], dim=1)


class SqueezeNet(nn.Module):
    """CIFAR SqueezeNet (reference models/SqueezeNet.py:58-120)."""

    def __init__(self):
        super().__init__()
        self.conv_1 = BasicConv2d(3, 64, 3, padding=1)
        self.avgpool_1 = nn.AvgPool2d((3, 3), stride=2, padding=1)
        self.fire_2 = Fire(64, "fire2")
        self.fire_3 = Fire(128, "fire3")
        self.fire_4 = Fire(128, "fire4")
        self.avgpool_4 = nn.AvgPool2d((3, 3), stride=2, padding=1)
        self.fire_5 = Fire(256, "fire5")
        self.fire_6 = Fire(256, "fire6")
        self.fire_7 = Fire(384, "fire7")
        self.fire_8 = Fire(384, "fire8")
        self.avgpool_8 = nn.AvgPool2d((3, 3), stride=2, padding=1)
        self.fire_9 = Fire(512, "fire9")
        self.conv_10 = BasicConv2d(512, 10, 1)
        self.avgpool_10 = nn.AdaptiveAvgPool2d(1)

    def forward(self, x):
        x = self.avgpool_1(self.conv_1(x))
        x = self.avgpool_4(self.fire_4(self.fire_3(self.fire_2(x))))
        x = self.avgpool_8(self.fire_8(self.fire_7(self.fire_6(self.fire_5(x)))))
        x = self.avgpool_10(self.conv_10(self.fire_9(x)))
        return x.view(-1, 10)


# --------------------------------------------------------------- MobileNet
class DepthwiseConv2d(nn.Module):
    def __init__(self, in_ch, out_ch, ksize=3, stride=1, padding=1):
        super().__init__()
        self.dwConv2d = nn.Conv2d(in_ch, in_ch, ksize, stride=stride,
                                  padding=padding, groups=in_ch, bias=False)
        self.bn = nn.BatchNorm2d(in_ch)
        self.pointwiseConv2d = BasicConv2d(in_ch, out_ch, 1)
        self.mish = nn.SiLU()

    def forward(self, x):
        x = self.mish(self.bn(self.dwConv2d(x)))
        return self.pointwiseConv2d(x)


class MobileNet(nn.Module):
    """CIFAR MobileNetV1 (reference models/MobileNet.py:58-90)."""

    def __init__(self, num_classes=10):
        super().__init__()
        self.pre_layer = BasicConv2d(3, 32, 3, padding=1)
        self.layers = nn.Sequential(
            DepthwiseConv2d(32, 64),
            DepthwiseConv2d(64, 128, stride=2),
            DepthwiseConv2d(128, 128),
            DepthwiseConv2d(128, 256, stride=2),
            DepthwiseConv2d(256, 256),
            DepthwiseConv2d(256, 512, stride=2),
            DepthwiseConv2d(512, 512),
            DepthwiseConv2d(512, 512),
            DepthwiseConv2d(512, 512),
            DepthwiseConv2d(512, 512),
            DepthwiseConv2d(512, 512),
            DepthwiseConv2d(512, 1024, stride=2),
            DepthwiseConv2d(1024, 1024),
        )
        self.avgpool = nn.AvgPool2d(2)
        self.linear = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.layers(self.pre_layer(x))
        x = self.avgpool(x)
        return self.linear(x.view(x.size(0), -1))


def alexnet():
    return AlexNet()


def lenet():
    return LeNet()


def vgg16():
    return VGG16()


def squeezenet():
    return SqueezeNet()


def mobilenet():
    return MobileNet()
