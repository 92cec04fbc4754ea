"""VGG-BN multi-scale backbones (port of tiseg_tpu/models/backbones/vgg.py).

A VGG16-BN/VGG19-BN trunk cut into 6 stages returning the feature pyramid
at strides (1, 2, 4, 8, 16, 32) with channels (64, 128, 256, 512, 512, 512).
Stage s > 0 starts with a 2x2 max-pool; the last stage is pool-only.
Module names follow the reference's torchvision slices
(``stages.{s}.{seq}``, tiseg/models/backbones/torch_vgg.py:44-60), so the
convs carry the reference's biases. The JAX package's convs under BN have
none, so the port's stay zero and out of training (``requires_grad``
False): before a train-mode BN their gradient is float noise, which Adam
would turn into steps of ~lr. A loaded bias folds into the BN's running
mean (``backbones/torch_port.py``).
"""
from __future__ import annotations

from torch import nn

from ..builder import BACKBONES
from ..nn import BatchNorm2d, Conv2d

# convs per stage (stages 1..4 start with a pool; stage 5 is pool only)
VGG_STAGE_CONVS = {
    'vgg16_bn': (2, 2, 3, 3, 3),
    'vgg19_bn': (2, 2, 4, 4, 4),
}
VGG_STAGE_CHANNELS = (64, 128, 256, 512, 512)


class VGG(nn.Module):

    def __init__(self, model_name: str = 'vgg16_bn', device=None):
        super().__init__()
        stages = []
        in_ch = 3
        for s, n_convs in enumerate(VGG_STAGE_CONVS[model_name]):
            layers = [nn.MaxPool2d(2, 2)] if s > 0 else []
            for _ in range(n_convs):
                out_ch = VGG_STAGE_CHANNELS[s]
                conv = Conv2d(in_ch, out_ch, 3, padding=1, device=device, into_norm=True)
                conv.bias.requires_grad_(False)
                layers += [conv, BatchNorm2d(out_ch, eps=1e-5, momentum=0.1, device=device), nn.ReLU()]
                in_ch = out_ch
            stages.append(nn.Sequential(*layers))
        stages.append(nn.Sequential(nn.MaxPool2d(2, 2)))
        self.stages = nn.ModuleList(stages)

    def forward(self, x):
        """x: NCHW. Returns the 6 pyramid levels (NCHW)."""
        outs = []
        for stage in self.stages:
            x = stage(x)
            outs.append(x)
        return outs


@BACKBONES.register_module()
class VGG16BN(VGG):

    def __init__(self, device=None):
        super().__init__('vgg16_bn', device=device)


@BACKBONES.register_module()
class VGG19BN(VGG):

    def __init__(self, device=None):
        super().__init__('vgg19_bn', device=device)
