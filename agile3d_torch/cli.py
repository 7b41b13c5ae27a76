"""The reference's shared CLI flag block, for the port's four entry points
(counterpart of the JAX package's ``cli.py``).

The reference repeats one model-hyperparameter argparse block in its four
entry points (reference main.py:36-55, eval_multi_obj.py:37-58,
eval_single_obj.py:37-61, run_UI.py:30-52); a reference user's launch
scripts pass it, so every entry point here accepts the whole block. It is
registered once by :func:`add_reference_model_flags` and folded into the
typed config by :func:`model_config_from_args`.

``--device``: ``""`` (the default) or ``cuda`` runs on the card, ``cpu`` on
the CPU; a card that is asked for and missing is an error, never a silent
CPU run (``engine/eval.py::resolve_device``). The parallel flags
(``--num_dp``, ``--sp``) run one process per rank: on the card on
``nccl``, one card a rank, on the CPU on ``gloo``
(``parallel/mesh.py::launch``).
"""

from __future__ import annotations

import argparse
import sys

from agile3d_torch.config import BackboneConfig, ModelConfig

def add_reference_model_flags(p: argparse.ArgumentParser) -> None:
    """Register the reference's shared model flag block (main.py:36-55).

    ``type=bool`` flags keep the reference's argparse semantics: any
    non-empty value parses truthy, as reference users' scripts expect."""
    p.add_argument("--device", default="", type=str,
                   help="'' or 'cuda' (default): the card; 'cpu': the CPU")
    p.add_argument("--voxel_size", default=0.05, type=float)
    p.add_argument("--hidden_dim", default=128, type=int)
    p.add_argument("--dim_feedforward", default=1024, type=int)
    p.add_argument("--num_heads", default=8, type=int)
    p.add_argument("--num_decoders", default=3, type=int)
    p.add_argument("--num_bg_queries", default=10, type=int)
    p.add_argument("--dropout", default=0.0, type=float)
    p.add_argument("--pre_norm", default=False, type=bool)
    p.add_argument("--normalize_pos_enc", default=True, type=bool)
    p.add_argument("--positional_encoding_type", default="fourier")
    p.add_argument("--gauss_scale", default=1.0, type=float)
    p.add_argument("--hlevels", default=[4], type=int, nargs="+")
    p.add_argument("--shared_decoder", default=False, type=bool)
    p.add_argument("--aux", default=True, type=bool)
    p.add_argument("--bn_momentum", default=0.02, type=float)
    p.add_argument("--conv1_kernel_size", default=5, type=int)
    # the reference's spelling (reference main.py:36 '--dialations')
    p.add_argument("--dialations", default=[1, 1, 1, 1], type=int,
                   nargs="+")


def model_config_from_args(args, **overrides) -> ModelConfig:
    """Fold the shared reference flags into a typed ModelConfig.

    ``overrides`` are entry-point-specific ModelConfig fields with no
    reference flag (max_clicks, decoder_dtype, ...)."""
    dilations = tuple(args.dialations)
    if any(d != 1 for d in dilations):
        raise ValueError(
            f"--dialations {list(dilations)}: only undilated kernels are "
            "supported — the reference never runs any other value (its "
            "default [1,1,1,1] is the only configuration its shipped "
            "models and scripts use, reference main.py:36)")
    if args.conv1_kernel_size != 5:
        raise ValueError(
            f"--conv1_kernel_size {args.conv1_kernel_size}: only 5 is "
            "supported — the data pipeline pre-builds the stem's 125-column "
            "gather map (sparse/kernel_maps.build_pyramid stem_kernel=5), "
            "and the reference never runs any other value (its default 5 is "
            "the only configuration its shipped models use, reference "
            "main.py:37)")
    backbone = overrides.pop("backbone", None) or BackboneConfig(
        bn_momentum=args.bn_momentum,
        conv1_kernel_size=args.conv1_kernel_size)
    return ModelConfig(
        hidden_dim=args.hidden_dim,
        dim_feedforward=args.dim_feedforward,
        num_heads=args.num_heads,
        num_decoders=args.num_decoders,
        num_bg_queries=args.num_bg_queries,
        dropout=args.dropout,
        pre_norm=args.pre_norm,
        normalize_pos_enc=args.normalize_pos_enc,
        positional_encoding_type=args.positional_encoding_type,
        gauss_scale=args.gauss_scale,
        hlevels=tuple(args.hlevels),
        shared_decoder=args.shared_decoder,
        aux=args.aux,
        voxel_size=args.voxel_size,
        backbone=backbone,
        **overrides)


def device_arg(args) -> str:
    """The device ``--device`` names: the card unless it says ``cpu``."""
    return args.device or "cuda"


def check_val_batch_size(args) -> None:
    if args.val_batch_size != 1:
        raise SystemExit("--val_batch_size must be 1: eval rolls out one "
                         "scene at a time (the reference's only shipped "
                         "configuration, eval_multi_obj.py:94)")


def run(parser: argparse.ArgumentParser, main, argv=None):
    """Parse ``argv`` and run ``main``; a scene over the card's memory
    budget, or a parallel layout that the machine cannot hold, exits with
    one ``error: ...`` line and code 1, not a traceback."""
    from agile3d_torch.engine.eval import SceneTooLargeError
    from agile3d_torch.parallel.mesh import ParallelLayoutError

    args = parser.parse_args(argv)
    try:
        return main(args)
    except (SceneTooLargeError, ParallelLayoutError) as e:
        print(f"error: {e}", file=sys.stderr, flush=True)
        raise SystemExit(1) from None
