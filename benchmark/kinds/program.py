"""The bridge to the program under test: a configuration file as the
port's ``Config``, and the benchmark's weights in its model."""

from __future__ import annotations

import torch


def program_config(cfg: dict, decoder_dtype: str = "float32", **train):
    from agile3d_torch.config import (
        BackboneConfig,
        Config,
        ModelConfig,
        TrainConfig,
    )

    bb, dec = cfg["backbone"], cfg["decoder"]
    backbone = BackboneConfig(
        in_channels=bb["in_channels"], init_dim=bb["init_dim"],
        planes=tuple(bb["planes"]), layers=tuple(bb["layers"]),
        conv1_kernel_size=bb["conv1_kernel_size"],
        bn_momentum=bb["bn_momentum"])
    model = ModelConfig(
        hidden_dim=dec["hidden_dim"], dim_feedforward=dec["dim_feedforward"],
        num_heads=dec["num_heads"], num_decoders=dec["num_decoders"],
        num_bg_queries=dec["num_bg_queries"], dropout=dec["dropout"],
        pre_norm=dec["pre_norm"], normalize_pos_enc=dec["normalize_pos_enc"],
        positional_encoding_type=dec["positional_encoding_type"],
        gauss_scale=dec["gauss_scale"], hlevels=tuple(dec["hlevels"]),
        shared_decoder=dec["shared_decoder"], voxel_size=cfg["voxel_size"],
        backbone=backbone, max_fg_objects=dec["max_fg_objects"],
        max_clicks=dec["max_clicks"], time_table_len=dec["time_table_len"],
        decoder_dtype=decoder_dtype)
    return Config(model=model, train=TrainConfig(**train))


@torch.no_grad()
def load_weights(model, weights: dict) -> None:
    """The benchmark's weights into the program's model, by name; every
    parameter and persistent buffer must have one."""
    missing, unexpected = model.load_state_dict(weights, strict=False)
    if missing or unexpected:
        raise KeyError(f"weights do not match the model: missing "
                       f"{missing[:4]}, unexpected {unexpected[:4]}")
