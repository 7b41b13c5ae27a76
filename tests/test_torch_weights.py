"""The port's weight bridge against the JAX package's exporter: JAX init ->
``export_torch_state_dict`` (the reference AGILE3D state-dict layout) ->
port ``load_reference_state_dict`` -> port ``export_reference_state_dict``
gives back identical arrays, and the port's sparse-conv kernels land in
``kernel_offsets`` order exactly as the JAX package holds them."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from agile3d_torch import config as pcfg
from agile3d_torch.models.agile3d import Agile3D
from agile3d_torch.sparse.kernel_maps import ME_KERNEL_PERM, me_kernel_perm
from agile3d_torch.utils.ckpt import (
    export_reference_state_dict,
    load_reference_state_dict,
)
from agile3d_tpu.config import ModelConfig
from agile3d_tpu.models.agile3d import init_agile3d
from agile3d_tpu.sparse.kernel_maps import ME_KERNEL_PERM as JAX_ME_KERNEL_PERM
from agile3d_tpu.utils.ckpt import export_torch_state_dict

torch.set_num_threads(1)


def port_model_config(jcfg: ModelConfig) -> pcfg.ModelConfig:
    """The port's ModelConfig with every field the two packages share taken
    from the JAX one; the attention thresholds under their port names
    (``xla_attn_chunk`` -> ``attn_chunk``, ``xla_attn_dense_threshold`` ->
    ``attn_dense_threshold``)."""
    def pick(cls, src, **extra):
        kw = {f.name: getattr(src, f.name) for f in dataclasses.fields(cls)
              if hasattr(src, f.name) and f.name not in extra}
        return cls(**kw, **extra)

    bb = pick(pcfg.BackboneConfig, jcfg.backbone, banded_conv=None)
    return pick(pcfg.ModelConfig, jcfg, backbone=bb,
                attn_chunk=jcfg.xla_attn_chunk,
                attn_dense_threshold=jcfg.xla_attn_dense_threshold)


@pytest.fixture(scope="module")
def exported():
    jcfg = ModelConfig()
    params, buffers, bn_state = init_agile3d(jax.random.PRNGKey(3), jcfg)
    sd = export_torch_state_dict(params, buffers, jcfg, bn_state)
    return jcfg, params, sd


def test_round_trip_is_exact(exported):
    jcfg, _, sd = exported
    model = Agile3D(port_model_config(jcfg))
    load_reference_state_dict(model, sd)
    back = export_reference_state_dict(model)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


def test_kernels_land_in_offset_order(exported):
    """The bridge applies ME_KERNEL_PERM: after loading, the port's kernels
    equal the JAX package's own (kernel_offsets-order) weights, for the
    k5 stem, a k3 block conv and a k2 down conv, and the packed attention
    projection splits into the JAX q/k/v matrices."""
    jcfg, params, sd = exported
    model = Agile3D(port_model_config(jcfg))
    load_reference_state_dict(model, {k: torch.tensor(np.asarray(v))
                                      for k, v in sd.items()})
    bp = params["backbone"]
    pairs = [
        (model.backbone.conv0p1s1.kernel, bp["conv0p1s1"]["w"]),
        (model.backbone.block8[1].conv2.kernel, bp["block8"][1]["conv2"]["w"]),
        (model.backbone.conv2p2s2.kernel, bp["conv2"]["w"]),
        (model.backbone.block1[0].norm1.bn.running_var,
         np.ones(jcfg.backbone.planes[0], np.float32)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    attn = model.c2s_attention[1][0].multihead_attn
    q_w, k_w, v_w = attn.in_proj_weight.detach().numpy().reshape(3, -1,
                                                                  jcfg.hidden_dim)
    a = params["decoders"][1]["c2s"]["attn"]
    for got, name in ((q_w, "q_w"), (k_w, "k_w"), (v_w, "v_w")):
        np.testing.assert_array_equal(got, np.asarray(a[name]).T)
    np.testing.assert_array_equal(model.pos_enc.gauss_B.numpy(),
                                  np.asarray(sd["pos_enc.gauss_B"]))


@pytest.mark.parametrize("k", [2, 3, 5])
def test_me_kernel_perm_matches_jax(k):
    np.testing.assert_array_equal(ME_KERNEL_PERM[k ** 3],
                                  JAX_ME_KERNEL_PERM[k ** 3])
    assert sorted(me_kernel_perm(k).tolist()) == list(range(k ** 3))


def test_missing_or_misshapen_weights_raise(exported):
    jcfg, _, sd = exported
    model = Agile3D(port_model_config(jcfg))
    short = dict(sd)
    del short["decoder_norm.bias"]
    with pytest.raises(KeyError):
        load_reference_state_dict(model, short)
    bad = dict(sd)
    bad["decoder_norm.bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError):
        load_reference_state_dict(model, bad)
