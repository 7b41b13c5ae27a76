"""The port's process groups (``agile3d_torch/parallel/mesh.py``) on the
CPU: the collectives with JAX's names on spawned ``gloo`` groups of 2 and 4
ranks against their definitions, ``make_mesh``'s layouts and refusals (as
the JAX package's ``make_mesh`` refuses a mesh larger than its devices;
here a layout smaller than the world too), the one-line refusal of a
``nccl`` layout larger than the machine's cards, before any process
starts, and ``launch`` under ``torchrun``: it joins a group of the asked
size and refuses one of another size in one line."""

import contextlib
import io

import pytest
import torch

from agile3d_torch.cli import run
from agile3d_torch.parallel import mesh as pmesh
from agile3d_tpu.parallel import make_mesh as jax_make_mesh
from tests import torch_parallel_ranks as ranks


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_and_layouts(world):
    got = pmesh.spawn(ranks.collectives, world, world, device="cpu")
    assert [g["index"] for g in got] == list(range(world))
    x = [[1.5 * r, -r, 2.0 ** r] for r in range(world)]
    cols = list(zip(*x))
    for g in got:   # the same on every rank
        assert g["psum"] == pytest.approx([sum(c) for c in cols], abs=0)
        assert g["pmax"] == [max(c) for c in cols]
        assert g["pmin"] == [min(c) for c in cols]
        assert g["gather"] == [i + 10 * r for r in range(world)
                               for i in range(3)]
        assert g["gather_2d"] == [[r, r] for r in range(world)
                                  for _ in range(2)]
        assert g["psum_bf16"] and g["pmax_bool"]
        assert g["psum_scalar"] == world * (world + 1) // 2
        assert g["refused"] == [
            f"mesh {world}x2 needs {2 * world} processes, have {world}",
            f"mesh 1x1 needs 1 processes, have {world}"]
    # rank = dp_index * n_sp + sp_index, JAX's reshape(n_dp, n_sp)
    for n_dp in {1, 2, world}:
        n_sp = world // n_dp
        for rank, g in enumerate(got):
            lay = g["layouts"][n_dp]
            assert lay["dp"] == (n_dp, rank // n_sp)
            assert lay["sp"] == (n_sp, rank % n_sp)
            assert lay["dp_sum"] == n_dp and lay["sp_sum"] == n_sp
            base = rank // n_sp * n_sp
            assert lay["sp_gather"] == list(range(base, base + n_sp))


def test_one_process_layout_and_refusals():
    """Without a group only the one-rank layout exists; its collectives
    are the identity."""
    mesh = pmesh.make_mesh(n_dp=1, n_sp=1, device="cpu")
    assert mesh.shape == {"dp": 1, "sp": 1}
    x = torch.arange(4.0)
    for fn in (pmesh.psum, pmesh.pmax, pmesh.pmin, pmesh.all_gather):
        assert fn(x, mesh["sp"]) is x
    assert pmesh.axis_index(mesh["dp"]) == 0
    with pytest.raises(ValueError, match="needs 2 processes"):
        pmesh.make_mesh(n_dp=1, n_sp=2, device="cpu")
    with pytest.raises(ValueError, match="needs"):
        jax_make_mesh(n_dp=16, n_sp=2)


def test_nccl_needs_a_card_per_rank():
    have = torch.cuda.device_count()
    with pytest.raises(pmesh.ParallelLayoutError,
                       match=f"{have + 1} ranks on nccl need {have + 1} CUDA "
                             f"devices, this machine has {have}"):
        pmesh.check_layout(have + 1, "nccl")
    pmesh.check_layout(have + 1, "gloo")
    assert pmesh.backend_for("cuda") == "nccl"
    assert pmesh.backend_for("cpu") == "gloo"


@pytest.mark.parametrize("cli,argv", [
    ("eval_multi_obj", ["--scan_folder", "s", "--val_list", "v", "--sp",
                        "{n}"]),
    ("main", ["--num_dp", "{n}"]),
])
def test_cli_refuses_more_ranks_than_cards_in_one_line(cli, argv,
                                                       monkeypatch):
    """``--sp N`` / ``--num_dp N`` on the card with fewer than N cards and
    no group: one ``error:`` line and exit code 1, before any process or
    model exists (no silent one-process or CPU run)."""
    import importlib

    mod = importlib.import_module(f"agile3d_torch.{cli}")
    n = max(2, torch.cuda.device_count() + 1)
    monkeypatch.setattr(pmesh, "spawn", lambda *a, **k: pytest.fail(
        "spawned ranks"))
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as ex:
        run(mod.get_args_parser(), mod.main,
            [a.format(n=n) for a in argv])
    assert ex.value.code == 1
    lines = err.getvalue().strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith(
        f"error: {n} ranks on nccl need {n} CUDA devices"), lines


def test_launch_joins_a_torchrun_group(tmp_path):
    """Under ``torchrun`` (its environment names the world and the
    rendezvous) ``launch`` joins that group, runs the function once a
    process, and leaves the group after; rank 0 gets the result."""
    import json
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mp.start_processes(ranks.torchrun_like, args=(port, str(tmp_path)),
                       nprocs=2, start_method="spawn")
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.json") as f:
            got = json.load(f)
        assert got == {"view": [rank, 2, 1.0], "left_group": True}


@pytest.mark.parametrize("cli,argv", [
    ("eval_multi_obj", ["--scan_folder", "s", "--val_list", "v", "--sp", "2",
                        "--device", "cpu"]),
    ("main", ["--num_dp", "2", "--device", "cpu"]),
])
def test_launch_refuses_a_torchrun_group_of_another_size(cli, argv,
                                                         monkeypatch):
    """``torchrun --nproc_per_node 4 ... --num_dp 2``: each of the four
    processes would otherwise spawn a group of its own on the same cards,
    each with a rank 0 writing the same files. ``launch`` refuses before
    joining or spawning, and the CLI exits with its one line."""
    import importlib

    mod = importlib.import_module(f"agile3d_torch.{cli}")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setattr(pmesh, "spawn", lambda *a, **k: pytest.fail(
        "spawned ranks"))
    monkeypatch.setattr(pmesh.dist, "init_process_group",
                        lambda *a, **k: pytest.fail("joined a group"))
    with pytest.raises(pmesh.ParallelLayoutError,
                       match="2 ranks asked for under torchrun's "
                             "WORLD_SIZE=4"):
        pmesh.launch(2, lambda: None, device="cpu")
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as ex:
        run(mod.get_args_parser(), mod.main, argv)
    assert ex.value.code == 1
    lines = err.getvalue().strip().splitlines()
    assert lines == ["error: 2 ranks asked for under torchrun's WORLD_SIZE=4: "
                     "give torchrun 2 processes"], lines
