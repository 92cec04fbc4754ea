"""tiseg_tpu_torch: the PyTorch/CUDA port of tiseg_tpu for NVIDIA Hopper.

It imports nothing of the JAX package; each module keeps the name of its
``tiseg_tpu`` counterpart. Entry points run on ``cuda`` unless the caller
passes ``device='cpu'``.
"""
__version__ = '0.1.0'
