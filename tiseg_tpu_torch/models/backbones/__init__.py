from .resnet import BasicBlock, Bottleneck, ResNet, ResNetExt
from .vgg import VGG, VGG16BN, VGG19BN

__all__ = ['BasicBlock', 'Bottleneck', 'ResNet', 'ResNetExt', 'VGG', 'VGG16BN', 'VGG19BN']
