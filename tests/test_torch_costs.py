"""The port's operation, byte and row counts (``utils/costs.py``) against the
JAX package's: integer for integer on the same pyramid, for Res16UNet34C
and a reduced Bottleneck variant, useful and padded; the decoder's at both
dtypes."""

import dataclasses

import numpy as np
import pytest

from agile3d_torch.config import BackboneConfig as PBackbone
from agile3d_torch.config import ModelConfig as PModel
from agile3d_torch.data.datasets import collate_scenes as port_collate
from agile3d_torch.utils import costs as pcosts
from agile3d_tpu.config import BackboneConfig, ModelConfig
from agile3d_tpu.data.datasets import collate_scenes
from agile3d_tpu.utils import costs as jcosts
from tests.test_torch_model import small_scene

BOTTLENECK = dict(init_dim=16, planes=(16, 16, 32, 32, 32, 32, 32, 32),
                  layers=(1, 2, 1, 1, 1, 1, 2, 1), block="bottleneck")
CONFIGS = {"Res16UNet34C": ({}, {}), "bottleneck": (BOTTLENECK, BOTTLENECK)}


@pytest.fixture(scope="module")
def pyramids():
    jsample, psample = small_scene(9, n_points=4000, num_obj=3)
    return (collate_scenes([jsample]).pyramid,
            port_collate([psample]).pyramid)


def _ops(costs):
    return [(c.name, c.flops, c.stream_bytes, c.gather_rows) for c in costs]


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("padded", [False, True])
def test_backbone_costs_equal_jax(pyramids, name, padded):
    jpyr, ppyr = pyramids
    jkw, pkw = CONFIGS[name]
    jc, pc = BackboneConfig(**jkw), PBackbone(**pkw)
    assert pc.expansion == jc.expansion
    want = jcosts.backbone_costs(jpyr, jc, padded=padded)
    got = pcosts.backbone_costs(ppyr, pc, padded=padded)
    assert _ops(got) == _ops(want)
    s_got, s_want = pcosts.summarize(got), jcosts.summarize(want)
    for key in ("model_flops", "stream_bytes", "gather_rows"):
        assert s_got[key] == s_want[key], key
    t_got, t_want = pcosts.stage_table(got), jcosts.stage_table(want)
    assert list(t_got) == list(t_want)
    for stage in t_want:
        for key in ("gflops", "stream_mb", "gather_mrows"):
            assert t_got[stage][key] == t_want[stage][key], (stage, key)


def test_bottleneck_counts_its_expansion(pyramids):
    _, ppyr = pyramids
    names = [c.name for c in pcosts.backbone_costs(
        ppyr, PBackbone(**BOTTLENECK))]
    assert "down2/block2/b1/conv1x1b" in names
    assert "down1/block1/b0/downsample" in names
    assert not any(n.endswith("/conv1") for n in names)


@pytest.mark.parametrize("dtype_bytes", [4, 2])
def test_decoder_costs_equal_jax(dtype_bytes):
    jc = ModelConfig(num_decoders=2, hlevels=(4, 4), dim_feedforward=256)
    pc = dataclasses.replace(PModel(), num_decoders=2, hlevels=(4, 4),
                             dim_feedforward=256)
    for n, q in ((196_608, 42), (4096, 74)):
        assert _ops(pcosts.decoder_costs(n, q, pc, dtype_bytes)) == _ops(
            jcosts.decoder_costs(n, q, jc, dtype_bytes))


def test_summary_rates_and_guard_estimate():
    costs = [pcosts.OpCost("a", 989_000_000, 3_350_000, 7),
             pcosts.OpCost("b", 0, 6_700_000, 0)]
    s = pcosts.summarize(costs, measured_s=4e-6)
    assert s["model_flops"] == 989_000_000 and s["gather_rows"] == 7
    # op a: 1 us of products, 1 us of bytes; op b: 2 us of bytes
    np.testing.assert_allclose(s["roofline_floor_ms"], 0.003)
    np.testing.assert_allclose(s["mfu"], 0.25)
    np.testing.assert_allclose(s["frac_of_roofline"], 0.75)
    assert "gather_model_ms" not in s
    assert pcosts.eval_hbm_gib(2**30) == pcosts.EVAL_BYTES_PER_ROW
