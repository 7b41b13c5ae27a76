"""AGILE3D in PyTorch for NVIDIA Hopper (H100).

A second implementation of the JAX package's inference surface and its
training path: multi-object and single-object interactive evaluation, AP,
the annotation server, and training, with the same host prep (quantize,
coordinate pyramid, bucket padding), the Res16UNet backbones (34C by
default, the reference's 20 variants), the
click-as-query decoder (dense or chunked attention, f32 or the bf16
policy, by JAX's rules) and the click rollout on the device (eval's
default) or on the host. The backbone's banded sparse-conv kernels, the TPU
probes' kernels and the rollout's boundary distance are hand-written CUDA
C++ for ``sm_90a`` (``csrc/``); every other op is plain PyTorch.

The package imports torch and numpy only. Entry points run on ``cuda``
unless the caller asks for ``device="cpu"`` (``--device cpu``); the CLIs
take the JAX package's flags (``cli.py``), and ``bench`` / ``bench_train``
print its benches' one-line JSON results.
"""
