"""Unique-scene scaling table for the diffusion surrogate.

Collates holdout reports (examples/surrogate_report.py output npz) from
runs trained on different unique-scene counts / seeds into one markdown
table: per-run holdout ensemble-readout Pearson correlation, so the
10k-scene ceiling (ROADMAP, known limitation 5) can be compared against the 50k-scene runs
seed-by-seed rather than via one lucky basin.

Usage: python examples/surrogate_scaling_table.py LABEL=REPORT.npz ...
       (no args: the banked assets/surrogate_* reports)
"""
import sys

import numpy as np

DEFAULT = [
    ("10k scenes, 100 ep (r3 banked)", "assets/surrogate_x0/holdout_report.npz"),
    ("16k scenes, seed 0 (r4)", "assets/surrogate_16k_s0/holdout_report.npz"),
]


def row(label, path):
    try:
        d = np.load(path)
    except OSError:
        return f"| {label} | — | — | — | — | (missing: {path}) |"
    ce = d["corr_e"] if "corr_e" in d.files else d["corr"]
    rf = d["rel_fit_e"] if "rel_fit_e" in d.files else d["rel_fit"]
    cr = d["corr_r"] if "corr_r" in d.files else None
    one_call = f"{np.mean(cr):.3f}" if cr is not None else "—"
    return (f"| {label} | {np.mean(ce):.3f} | {np.median(ce):.3f} | "
            f"{np.max(ce):.3f} | {np.mean(rf):.3f} | {one_call} |")


def main(pairs):
    print("| run | ens. corr mean | median | best | rel-L2 (fit) | "
          "one-call corr |")
    print("|---|---|---|---|---|---|")
    for label, path in pairs:
        print(row(label, path))


if __name__ == "__main__":
    args = [a.split("=", 1) for a in sys.argv[1:]]
    main([(a[0], a[1]) for a in args] if args else DEFAULT)
