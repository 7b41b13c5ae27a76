"""The port's four CLIs against the JAX package's: the same flags (less the
seven that wait for checkpoints and the parallel paths), the reference
model block folded into the same config fields, and the same guards."""

import dataclasses
import importlib

import pytest

from agile3d_torch import cli as pcli
from agile3d_torch import config as pcfg
from agile3d_tpu.cli import model_config_from_args as jax_model_config
from tests.test_cli_flags import MODEL_FLAGS

# JAX entry point (the repository's root module) -> the port's
CLIS = {"eval_multi_obj": "agile3d_torch.eval_multi_obj",
        "eval_single_obj": "agile3d_torch.eval_single_obj",
        "run_ui": "agile3d_torch.run_ui",
        "main": "agile3d_torch.main"}
WAITING = {"eval_multi_obj": {"--sp", "--sp_backbone", "--scene_parallel"},
           "eval_single_obj": set(), "run_ui": set(),
           "main": {"--resume", "--start_epoch", "--ckpt_epochs",
                    "--num_dp"}}
REQUIRED = {"eval_multi_obj": ["--scan_folder", "s", "--val_list", "v"],
            "eval_single_obj": ["--scan_folder", "s", "--val_list", "v"],
            "run_ui": [], "main": []}


def _flags(parser) -> set:
    return {o for a in parser._actions for o in a.option_strings
            if o.startswith("--") and o != "--help"}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_flags_are_jax_flags_less_the_waiting_ones(name):
    jax_flags = _flags(importlib.import_module(name).get_args_parser())
    port = importlib.import_module(CLIS[name]).get_args_parser()
    assert jax_flags - _flags(port) == WAITING[name]
    for flag in WAITING[name]:
        assert flag in pcli.not_ported_epilog(name)


def test_waiting_flags_are_the_seven():
    assert set().union(*WAITING.values()) == {
        "--resume", "--start_epoch", "--ckpt_epochs", "--num_dp", "--sp",
        "--sp_backbone", "--scene_parallel"}
    assert {k: set(v) for k, v in pcli.NOT_PORTED.items()} == {
        k: v for k, v in WAITING.items() if v}


def _shared_fields(port_obj, jax_obj) -> dict:
    names = ({f.name for f in dataclasses.fields(port_obj)}
             & {f.name for f in dataclasses.fields(jax_obj)})
    return {n: (getattr(port_obj, n), getattr(jax_obj, n)) for n in names
            if n != "backbone"}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_reference_block_gives_jax_config(name):
    argv = MODEL_FLAGS + REQUIRED[name]
    jargs = importlib.import_module(name).get_args_parser().parse_args(argv)
    pargs = importlib.import_module(CLIS[name]).get_args_parser().parse_args(
        argv)
    got, want = pcli.model_config_from_args(pargs), jax_model_config(jargs)
    for field, (g, w) in _shared_fields(got, want).items():
        assert g == w, field
    for field, (g, w) in _shared_fields(got.backbone, want.backbone).items():
        assert g == w, f"backbone.{field}"
    assert got.hidden_dim == 64 and got.hlevels == (4, 4)
    assert got.backbone.bn_momentum == 0.05 and got.dropout == 0.1
    assert pcli.device_arg(pargs) == "cuda"


def test_defaults_give_default_config():
    args = importlib.import_module(CLIS["run_ui"]).get_args_parser() \
        .parse_args([])
    got = pcli.model_config_from_args(args)
    assert got == pcfg.ModelConfig()
    assert pcli.device_arg(args) == "cuda"
    args.device = "cpu"
    assert pcli.device_arg(args) == "cpu"


def test_train_config_from_flags():
    from agile3d_torch import main as pmain

    args = pmain.get_args_parser().parse_args(MODEL_FLAGS + [
        "--losses", "bce", "dice", "--num_workers", "3",
        "--val_batch_size", "1", "--train_list", "t.json", "--aux", ""])
    cfg = pmain.build_config(args)
    assert cfg.model.hidden_dim == 64 and cfg.model.hlevels == (4, 4)
    assert cfg.loss.losses == ("bce", "dice")
    assert cfg.loss.aux is False and cfg.model.aux is False
    assert cfg.train.num_workers == 3 and cfg.train.prefetch == 3
    assert cfg.train.val_batch_size == 1


@pytest.mark.parametrize("flags,match", [
    (["--dialations", "1", "2", "1", "1"], "dialations"),
    (["--conv1_kernel_size", "3"], "conv1_kernel_size"),
])
def test_model_block_guards_match_jax(flags, match):
    import main as jax_main

    from agile3d_torch import main as pmain

    with pytest.raises(ValueError, match=match):
        jax_model_config(jax_main.get_args_parser().parse_args(flags))
    with pytest.raises(ValueError, match=match) as port_err:
        pcli.model_config_from_args(pmain.get_args_parser().parse_args(flags))
    with pytest.raises(ValueError) as jax_err:
        jax_model_config(jax_main.get_args_parser().parse_args(flags))
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("name", ["eval_multi_obj", "eval_single_obj"])
def test_val_batch_size_guard(name):
    mod = importlib.import_module(CLIS[name])
    args = mod.get_args_parser().parse_args(
        REQUIRED[name] + ["--val_batch_size", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="val_batch_size"):
        mod.main(args)
    jmod = importlib.import_module(name)
    with pytest.raises(SystemExit, match="val_batch_size"):
        jmod.main(jmod.get_args_parser().parse_args(
            REQUIRED[name] + ["--val_batch_size", "2"]))


@pytest.mark.parametrize("name", ["eval_multi_obj", "eval_single_obj",
                                  "main"])
def test_dropout_reaches_the_not_ported_error(name):
    mod = importlib.import_module(CLIS[name])
    args = mod.get_args_parser().parse_args(
        REQUIRED[name] + ["--dropout", "0.1", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="dropout"):
        mod.main(args, log=lambda m: None)


def test_run_ui_dropout_reaches_the_not_ported_error(tmp_path):
    import numpy as np

    from agile3d_torch import run_ui
    from agile3d_torch.data.ply import write_ply
    from agile3d_torch.data.synthetic import make_scene

    (tmp_path / "scene_a").mkdir()
    coords, colors, _ = make_scene(np.random.default_rng(0), n_points=300)
    write_ply(str(tmp_path / "scene_a" / "scan.ply"),
              {"x": coords[:, 0], "y": coords[:, 1], "z": coords[:, 2],
               "R": colors[:, 0], "G": colors[:, 1], "B": colors[:, 2]})
    args = run_ui.get_args_parser().parse_args(
        ["--dropout", "0.1", "--device", "cpu", "--dataset_scenes",
         str(tmp_path)])
    with pytest.raises(NotImplementedError, match="dropout"):
        run_ui.main(args)


def test_training_takes_multi_object_data_only():
    from agile3d_torch import main as pmain

    args = pmain.get_args_parser().parse_args(
        ["--dataset_mode", "single_obj", "--device", "cpu"])
    with pytest.raises(SystemExit, match="multi_obj"):
        pmain.main(args)


def test_the_card_by_default_is_no_silent_cpu():
    """Without a card, the default device is an error, not the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(CLIS["eval_multi_obj"])
    args = mod.get_args_parser().parse_args(REQUIRED["eval_multi_obj"])
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(args)
