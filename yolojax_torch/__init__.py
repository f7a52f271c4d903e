"""yolojax_torch: the PyTorch / CUDA (H100) port of yolojax.

Module names follow ``yolojax/`` so each port file sits beside its
reference: ``yolojax_torch/nn/layers.py`` ports ``yolojax/nn/layers.py``,
and so on. Public functions keep yolojax's layouts (images NHWC in [0, 1],
v2 head ``(N, H, W, A, 5+C)``, boxes ``(ymin, xmin, ymax, xmax)``
normalised). The package imports torch and never jax or yolojax.
"""
