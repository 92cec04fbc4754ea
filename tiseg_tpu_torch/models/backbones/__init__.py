from .vgg import VGG, VGG16BN, VGG19BN

__all__ = ['VGG', 'VGG16BN', 'VGG19BN']
