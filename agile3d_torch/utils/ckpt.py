"""Weight bridge: the reference AGILE3D state-dict layout <-> ``Agile3D``.

The port's modules carry the reference's names (``backbone.block8.1.conv2.
kernel``, ``backbone.bn0.bn.running_var``, ``c2s_attention.0.0.
multihead_attn.in_proj_weight``, ...), so loading is a key-for-key copy
with one change: sparse-conv kernels [K, cin, cout] are stored in
MinkowskiEngine's offset order and are reordered into ``kernel_offsets``
order with ``ME_KERNEL_PERM``. This is the layout that
the JAX package's ``utils/ckpt.py::export_torch_state_dict`` writes and the
released ``checkpoint1099.pth`` holds (its ``"model"`` entry).

Training writes resumable checkpoints: ``{"model": that state dict,
"optimizer": Optimizer.state_dict(), "epoch": e}``, the shape of the
reference's own per-epoch dict (reference main.py:190-202).
``load_training_checkpoint`` restores one whole, and takes any other
``.pth`` (the released one among them) as weights alone.
``optimizer_state_from_optax`` carries the JAX package's optax AdamW state
across to the port's optimizer.
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


def save_checkpoint(path: str, model: torch.nn.Module, epoch: int,
                    optimizer=None) -> None:
    """Write ``{"model": reference-layout state dict, "epoch": epoch}``,
    with ``"optimizer": optimizer.state_dict()`` (on the CPU) when an
    optimizer is given, to ``path`` (a ``.pth`` that ``load_checkpoint``
    and the reference read) by a temporary file and a rename, so that a
    run cut mid-write leaves the previous file whole."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in export_reference_state_dict(model).items()}
    ckpt = {"model": sd, "epoch": int(epoch)}
    if optimizer is not None:
        state = optimizer.state_dict()
        ckpt["optimizer"] = {
            "count": state["count"],
            "params": {n: {k: v.detach().cpu() for k, v in st.items()}
                       for n, st in state["params"].items()}}
    tmp = f"{path}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)


def load_training_checkpoint(path: str, model: torch.nn.Module,
                             optimizer) -> int | None:
    """Resume from ``path``. A resumable checkpoint (one with an
    ``"optimizer"`` entry) restores the weights and BatchNorm statistics,
    the optimizer's state and returns the epoch it was written after; any
    other ``.pth`` loads the weights alone (the JAX package's ``.pth``
    branch), leaves the optimizer as it is and returns None."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    load_reference_state_dict(model, ckpt.get("model", ckpt))
    if "optimizer" not in ckpt:
        return None
    optimizer.load_state_dict(ckpt["optimizer"])
    return int(ckpt["epoch"])


def optimizer_state_from_optax(model: torch.nn.Module, count: int, mu: dict,
                               nu: dict) -> dict:
    """The port's ``Optimizer.state_dict()`` for ``model`` from the JAX
    package's optimizer state (``make_optimizer``'s
    ``chain(clip_by_global_norm, adamw(schedule))``): ``count``, its update
    count (the adam stage's ``count``, which the schedule's equals), and
    ``mu`` / ``nu``, its first and second moments in the reference
    state-dict layout (``export_torch_state_dict`` of the moment trees:
    they are shaped like the parameters). Each moment is keyed and
    reordered as ``load_reference_state_dict`` keys and reorders that
    parameter."""
    params = {}
    for name, p in model.named_parameters():
        moments = []
        for ref in (mu, nu):
            t = torch.from_numpy(np.array(ref[name], np.float32))
            if _is_sparse_kernel(name, t):
                t = t[torch.as_tensor(ME_KERNEL_PERM[t.shape[0]])]
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: moment shape {tuple(t.shape)} != "
                                 f"{tuple(p.shape)}")
            moments.append(t)
        params[name] = {"step": torch.tensor(float(count)),
                        "exp_avg": moments[0], "exp_avg_sq": moments[1]}
    return {"count": int(count), "params": params}
