"""AP / AP50 / AP25 per click count from a single-object result CSV:
``python -m agile3d_torch.compute_ap [--result_file CSV]``."""

from __future__ import annotations

import argparse

from agile3d_torch.evaluation.ap import evaluate_ap


def get_args_parser():
    p = argparse.ArgumentParser(
        "Compute AP for interactive single-object segmentation")
    p.add_argument("--result_file",
                   default="results/val_results_single.csv", type=str)
    return p


def main(args) -> dict:
    table = evaluate_ap(args.result_file)
    for k, scores in table.items():
        print(f"Results for {k} clicks.")
        print(f"AP:   {scores['all_ap']}")
        print(f"AP50: {scores['all_ap_50%']}")
        print(f"AP25: {scores['all_ap_25%']}")
        print()
    return table


if __name__ == "__main__":
    main(get_args_parser().parse_args())
