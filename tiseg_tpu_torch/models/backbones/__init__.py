from .resnet import (BasicBlock, Bottleneck, DeeplabResNet50, DeeplabResNet101, ResNet, ResNet18, ResNet34, ResNet50,
                     ResNet101, ResNetExt, TorchResNet)
from .vgg import VGG, VGG16BN, VGG19BN

__all__ = ['BasicBlock', 'Bottleneck', 'DeeplabResNet50', 'DeeplabResNet101', 'ResNet', 'ResNet18', 'ResNet34',
           'ResNet50', 'ResNet101', 'ResNetExt', 'TorchResNet', 'VGG', 'VGG16BN', 'VGG19BN']
