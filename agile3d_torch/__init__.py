"""AGILE3D in PyTorch for NVIDIA Hopper (H100).

A second implementation of the multi-object interactive evaluation and
training paths of the JAX package: the same host prep (quantize, coordinate
pyramid, bucket padding), the Res16UNet34C backbone, the click-as-query
decoder, and the click rollout on the device (eval's default) or on the
host. The backbone's banded sparse-conv kernels, the TPU probes' kernels
and the rollout's boundary distance are hand-written CUDA C++ for
``sm_90a`` (``csrc/``); every other op is plain PyTorch in float32.

The package imports torch and numpy only. Entry points run on ``cuda``
unless the caller asks for ``device="cpu"``.
"""
