"""The port's KITTI-scale stress tool (``agile3d_torch/tools/stress_kitti.py``)
against the repository's JAX tool on the CPU: the same scene, voxel count,
padded bucket and chunked-attention decision as JAX's host prep and gate
(``tools/stress_kitti.py``) at the default 1.2M points and at a scene that
pads into the new 1,572,864-row bucket (host prep only); then the tool end
to end on a small scene, the sharded decoder on two spawned ranks."""

import dataclasses

import numpy as np
import pytest
import torch

from agile3d_tpu.config import DEFAULT_VOXEL_BUCKETS as JAX_BUCKETS
from agile3d_tpu.config import Config as JaxConfig
from agile3d_tpu.data.datasets import SceneSample as JaxSample
from agile3d_tpu.data.datasets import collate_scenes as jax_collate
from agile3d_tpu.data.synthetic import make_scene as jax_make_scene
from agile3d_tpu.sparse.quantize import sparse_quantize as jax_quantize
from agile3d_torch.tools import stress_kitti

torch.set_num_threads(1)


def _jax_prep(points: int, extent: float):
    """``tools/stress_kitti.py``'s scene, host prep and chunk gate."""
    cfg = JaxConfig(buckets=tuple(JAX_BUCKETS) + (1572864, 2097152))
    rng = np.random.default_rng(0)
    coords, colors, labels = jax_make_scene(rng, n_points=points, num_obj=10,
                                            extent=extent)
    coords += rng.standard_normal(coords.shape).astype(np.float32) * 0.04
    vox, umap, imap = jax_quantize(coords, cfg.model.voxel_size)
    sample = JaxSample(
        vox_coords=vox, raw_coords=coords[umap],
        feats=colors[umap].astype(np.float32) / 255.0,
        labels=labels[umap].astype(np.int32),
        labels_full=labels.astype(np.int32), inverse_map=imap,
        click_idx={}, scene_name="kitti_stress", num_obj=10)
    batch = jax_collate([sample], cfg.buckets)
    n_pad = batch.pyramid.levels[0].grid.shape[0]
    chunk = cfg.model.xla_attn_chunk
    engaged = bool(chunk and n_pad >= 2 * chunk and n_pad % chunk == 0)
    return len(vox), n_pad, engaged, batch, rng


@pytest.mark.parametrize("points,rows", [(1_200_000, 786432),
                                         (2_200_000, 1572864)])
def test_host_prep_and_gate_match_jax(points, rows):
    n_valid, n_pad, engaged, jbatch, jrng = _jax_prep(points, 22.0)
    cfg = stress_kitti.stress_config()
    coords, colors, labels, rng = stress_kitti.stress_scene(points, 22.0)
    batch, mine_valid, mine_pad = stress_kitti.host_prep(coords, colors,
                                                         labels, cfg)
    assert (mine_valid, mine_pad) == (n_valid, n_pad)
    assert mine_pad == rows
    assert [lv.grid.shape[0] for lv in batch.pyramid.levels] == \
        [lv.grid.shape[0] for lv in jbatch.pyramid.levels]
    np.testing.assert_array_equal(batch.raw, np.asarray(jbatch.raw))
    # the 30 clicks of the JAX tool come from the same generator state
    clicks = stress_kitti.click_table(rng, mine_valid, cfg, 32)
    np.testing.assert_array_equal(clicks.vox[:30],
                                  jrng.integers(0, n_valid, 30))
    chunk = stress_kitti.decoder_chunk(mine_pad, 32, cfg)
    assert (chunk > 0) == engaged
    assert chunk == cfg.model.attn_chunk


def test_stress_on_a_small_scene_with_two_ranks():
    res = stress_kitti.main(["--device", "cpu", "--points", "6000",
                             "--extent", "4", "--reps", "1", "--sp", "2"])
    assert res["device"].startswith("cpu") and res["rows"] == 8192
    assert res["finite"] and res["chunk"] == res["chunk_rule"] == 0
    assert res["backbone_passes"] == 3 and res["backbone_ms"] > 0
    assert res["forward_mask_ms"] > 0
    sp = res["sp"]
    assert sp["backend"] == "gloo" and sp["within_band"]
    assert sp["argmax_agreement"] == 1.0
    assert [r["rows_per_rank"] for r in sp["ranks"]] == [4096, 4096]
    # plain versions on the CPU: no kernel launch
    assert set(res["launches"].values()) == {0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_skip_backbone_fabricates_features(dtype):
    res = stress_kitti.main(["--device", "cpu", "--points", "6000",
                             "--extent", "4", "--reps", "1",
                             "--skip_backbone", "--decoder_dtype", dtype])
    assert res["finite"] and res["backbone_passes"] == 0
    assert "backbone_ms" not in res and res["forward_mask_ms"] > 0
    assert res["decoder_dtype"] == dtype


def test_sp_only_needs_sp():
    with pytest.raises(SystemExit):
        stress_kitti.main(["--device", "cpu", "--sp_only"])


def test_chunk_rule_at_kitti_size_matches_jax():
    """The port's rule and JAX's ``_pick_attn_chunk`` on the decoder's
    logits volume at the stress shapes."""
    from agile3d_tpu.models.agile3d import _pick_attn_chunk as jax_pick

    cfg = stress_kitti.stress_config()
    jcfg = JaxConfig().model
    for rows in (8192, 196608, 786432, 1572864, 2097152):
        for mc in (32, 64):
            vol = (cfg.model.num_bg_queries + mc) * rows * cfg.model.num_heads
            assert stress_kitti.decoder_chunk(rows, mc, cfg) == \
                jax_pick(rows, vol, dataclasses.replace(jcfg))
