"""Weight bridge: the reference AGILE3D state-dict layout <-> ``Agile3D``.

The port's modules carry the reference's names (``backbone.block8.1.conv2.
kernel``, ``backbone.bn0.bn.running_var``, ``c2s_attention.0.0.
multihead_attn.in_proj_weight``, ...), so loading is a key-for-key copy
with one change: sparse-conv kernels [K, cin, cout] are stored in
MinkowskiEngine's offset order and are reordered into ``kernel_offsets``
order with ``ME_KERNEL_PERM``. This is the layout that
the JAX package's ``utils/ckpt.py::export_torch_state_dict`` writes and the
released ``checkpoint1099.pth`` holds (its ``"model"`` entry).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from agile3d_torch.sparse.kernel_maps import ME_KERNEL_PERM


def _is_sparse_kernel(key: str, value) -> bool:
    return key.endswith(".kernel") and value.ndim == 3 \
        and value.shape[0] in ME_KERNEL_PERM


@torch.no_grad()
def load_reference_state_dict(model: torch.nn.Module, sd: dict) -> None:
    """Copy a reference-layout state dict (numpy arrays or tensors) into
    ``model`` in place. Every key of ``model.state_dict()`` must be present
    with the same shape; extra keys of ``sd`` (BatchNorm
    ``num_batches_tracked``, heads the eval path does not use) are ignored."""
    own = model.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"{len(missing)} weights missing from the state dict, "
                       f"e.g. {missing[:3]}")
    for key, dst in own.items():
        src = sd[key]
        if not torch.is_tensor(src):
            src = torch.from_numpy(np.array(src))
        if _is_sparse_kernel(key, src):
            src = src[torch.as_tensor(ME_KERNEL_PERM[src.shape[0]])]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{key}: shape {tuple(src.shape)} != "
                             f"{tuple(dst.shape)}")
        dst.copy_(src.to(dst.dtype))


def export_reference_state_dict(model: torch.nn.Module) -> dict:
    """The inverse of ``load_reference_state_dict``: numpy arrays keyed and
    ordered as the reference stores them."""
    out = {}
    for key, t in model.state_dict().items():
        a = t.detach().cpu().numpy()
        if _is_sparse_kernel(key, a):
            inv = np.empty_like(ME_KERNEL_PERM[a.shape[0]])
            inv[ME_KERNEL_PERM[a.shape[0]]] = np.arange(len(inv))
            a = a[inv]
        out[key] = a
    return out


def load_checkpoint(path: str, model: torch.nn.Module) -> None:
    """Load a reference ``.pth`` checkpoint (``{"model": state_dict, ...}``
    or a bare state dict) into ``model``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    load_reference_state_dict(model, ckpt.get("model", ckpt))


def save_checkpoint(path: str, model: torch.nn.Module, epoch: int) -> None:
    """Write ``{"model": reference-layout state dict, "epoch": epoch}`` to
    ``path`` (a ``.pth`` that ``load_checkpoint`` and the reference read).
    The optimizer's state is not saved."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in export_reference_state_dict(model).items()}
    tmp = f"{path}.tmp"
    torch.save({"model": sd, "epoch": int(epoch)}, tmp)
    os.replace(tmp, path)
