"""Aggregate results.json across scenes into a table (the port's twin of
show.py).

Usage:
  python -m gaussianprediction_tpu_torch.cli.show results/d-nerf_1.0/*/
  python -m gaussianprediction_tpu_torch.cli.show -r results/  # recursive
"""
from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dirs", nargs="*", help="dirs containing results.json")
    p.add_argument("-r", "--root", default=None,
                   help="search this tree for results.json files")
    return p


def main(argv=None):
    """Print the table for argv (None: sys.argv); returns it (None when no
    results.json was found)."""
    args = build_parser().parse_args(argv)

    from gaussianprediction_tpu_torch.eval.metrics import results_table

    result_dirs = {}
    if args.root:
        for dirpath, _, files in os.walk(args.root):
            if "results.json" in files:
                name = os.path.relpath(dirpath, args.root)
                result_dirs[name] = dirpath
    for d in args.dirs:
        if os.path.exists(os.path.join(d, "results.json")):
            result_dirs[os.path.basename(os.path.normpath(d))] = d
    if not result_dirs:
        print("no results.json found")
        return None
    table = results_table(result_dirs)
    print(table)
    return table


if __name__ == "__main__":
    main()
