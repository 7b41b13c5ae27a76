"""The port's four CLIs against the JAX package's: the same flags (the
seven that once waited, the three of checkpoints and resume and the four
of the parallel paths, are all ported), the reference model block folded
into the same config fields, and the same guards."""

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
WAITING = {"eval_multi_obj": set(), "eval_single_obj": set(),
           "run_ui": set(), "main": set()}
REQUIRED = {"eval_multi_obj": ["--scan_folder", "s", "--val_list", "v"],
            "eval_single_obj": ["--scan_folder", "s", "--val_list", "v"],
            "run_ui": [], "main": []}


def _flags(parser) -> set:
    return {o for a in parser._actions for o in a.option_strings
            if o.startswith("--") and o != "--help"}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_flags_are_jax_flags_less_the_waiting_ones(name):
    """Nothing waits any more: every flag of the JAX entry point is the
    port's, the parallel ones with JAX's defaults."""
    jax_parser = importlib.import_module(name).get_args_parser()
    port = importlib.import_module(CLIS[name]).get_args_parser()
    assert _flags(jax_parser) - _flags(port) == WAITING[name] == set()
    assert not hasattr(pcli, "NOT_PORTED")
    jdefaults = {a.dest: a.default for a in jax_parser._actions}
    for a in port._actions:
        if a.dest in ("num_dp", "sp", "sp_backbone", "scene_parallel"):
            assert a.default == jdefaults[a.dest], a.dest


@pytest.mark.parametrize("flags,route", [
    (["--sp", "2"], ("launch", 2)),
    (["--sp", "2", "--sp_backbone"], ("launch", 2)),
    (["--scene_parallel", "2", "--sp", "2"], ("scene_parallel", 2)),
    (["--num_dp", "3"], ("launch", 3)),
], ids=["sp", "sp_backbone", "scene_parallel", "num_dp"])
def test_waiting_flags_are_the_seven(flags, route, monkeypatch):
    """The four parallel flags (the last of the seven that once waited)
    parse and reach the parallel code: ``--sp`` and ``--num_dp`` the rank
    launcher with their rank count, ``--scene_parallel`` (which outranks
    ``--sp``, as in JAX) the scene-parallel loop with as many workers."""
    name = "main" if "--num_dp" in flags else "eval_multi_obj"
    mod = importlib.import_module(CLIS[name])
    args = mod.get_args_parser().parse_args(REQUIRED[name] + flags
                                            + ["--device", "cpu"])
    seen = []

    def fake_launch(world, fn, *fn_args, device):
        seen.append(("launch", world))
        assert fn.__name__ == ("_train" if name == "main" else "_evaluate")
        assert fn_args[0] is args and device == "cpu"

    def fake_parallel(cfg, model, dataset, results_file, *, devices, **kw):
        seen.append(("scene_parallel", len(devices)))
        raise _Built

    monkeypatch.setattr(mod, "launch", fake_launch)
    if name == "eval_multi_obj":
        monkeypatch.setattr(mod, "evaluate_dataset_parallel", fake_parallel)
        monkeypatch.setattr(mod, "build_dataset", lambda *a, **k: [])
    try:
        mod.main(args, log=lambda m: None)
    except _Built:
        pass
    assert seen == [route]
    if "--sp_backbone" in flags:
        assert args.sp_backbone


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


class _Built(Exception):
    """Raised by ``_spy_model`` once the entry point has built its model."""


def _spy_model(monkeypatch) -> list:
    """Agile3D.__init__ recording each model and then stopping the entry
    point (with ``_Built``)."""
    from agile3d_torch.models.agile3d import Agile3D

    built, init = [], Agile3D.__init__

    def spy(self, *args, **kwargs):
        init(self, *args, **kwargs)
        built.append(self)
        raise _Built

    monkeypatch.setattr(Agile3D, "__init__", spy)
    return built


def _assert_dropout_reached(built, rate=0.1):
    (model,) = built
    assert model.cfg.dropout == rate
    layers = [layer for name in ("c2s_attention", "c2c_attention",
                                 "ffn_attention", "s2c_attention")
              for group in getattr(model, name) for layer in group]
    assert layers and all(layer.dropout == rate for layer in layers)


@pytest.mark.parametrize("name", ["eval_multi_obj", "eval_single_obj",
                                  "main"])
def test_dropout_reaches_the_not_ported_error(name, monkeypatch):
    """``--dropout`` reaches the decoder's layers (until the decoder's
    dropout was ported, it reached a not-ported error there)."""
    mod = importlib.import_module(CLIS[name])
    args = mod.get_args_parser().parse_args(
        REQUIRED[name] + ["--dropout", "0.1", "--device", "cpu"])
    built = _spy_model(monkeypatch)
    with pytest.raises(_Built):
        mod.main(args, log=lambda m: None)
    _assert_dropout_reached(built)


def test_run_ui_dropout_reaches_the_not_ported_error(tmp_path, monkeypatch):
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
    built = _spy_model(monkeypatch)
    with pytest.raises(_Built):
        run_ui.main(args)
    _assert_dropout_reached(built)


def test_training_takes_multi_object_data_only(monkeypatch):
    """``--dataset_mode single_obj`` builds the single-object datasets for
    training and validation (until they were ported, training took
    multi-object data only; ``tests/test_torch_main.py`` runs it)."""
    from agile3d_torch import main as pmain

    modes = []

    def build_dataset(split, mode, **kw):
        modes.append((split, mode))
        if split == "val":
            raise _Built
        return []

    monkeypatch.setattr(pmain, "build_dataset", build_dataset)
    args = pmain.get_args_parser().parse_args(
        ["--dataset_mode", "single_obj", "--device", "cpu"])
    with pytest.raises(_Built):
        pmain.main(args, log=lambda m: None)
    assert modes == [("train", "single_obj"), ("val", "single_obj")]


def test_the_card_by_default_is_no_silent_cpu():
    """Without a card, the default device is an error, not the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(CLIS["eval_multi_obj"])
    args = mod.get_args_parser().parse_args(REQUIRED["eval_multi_obj"])
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(args)
