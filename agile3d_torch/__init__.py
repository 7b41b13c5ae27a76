"""AGILE3D in PyTorch for NVIDIA Hopper (H100).

A second implementation of the multi-object interactive evaluation path of
the JAX package: the same host prep (quantize, coordinate pyramid, bucket
padding), the Res16UNet34C backbone in eval mode, the click-as-query
decoder and the host click rollout. The two banded sparse-conv kernels of
the backbone are hand-written CUDA C++ for ``sm_90a`` (``csrc/``); every
other op is plain PyTorch in float32.

The package imports torch and numpy only. Entry points run on ``cuda``
unless the caller asks for ``device="cpu"``.
"""
