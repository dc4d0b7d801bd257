"""Dataset preprocessing CLI (counterpart of
``sdbc_tpu/cli/preprocess.py``), a host tool: the reference's
Data_preprocessing.ipynb as a command.

    python -m sdbc_tpu_torch.cli.preprocess --data_root ./goodreads \\
        --source_csv book_data.csv --n_test 5000
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--source_csv", type=str, default="book_data.csv")
    p.add_argument("--n_test", type=int, default=5000)
    p.add_argument("--english_threshold", type=float, default=0.97)
    p.add_argument("--reverify", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="re-decode both splits before writing (notebook "
                        "cell 17; ~2x wall-clock)")
    args = p.parse_args(argv)
    from sdbc_tpu_torch.data.preprocess import preprocess

    return preprocess(args.data_root, args.source_csv, args.n_test,
                      args.english_threshold, reverify=args.reverify)


if __name__ == "__main__":
    main()
