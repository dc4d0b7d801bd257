"""Precompute real-data FID statistics (counterpart of
``sdbc_tpu/cli/precalc_fid_stats.py``; the reference's
precalc_fid_stats.py:49-152).

The statistics stream over the image files with float64 running moments
(no staging file); the extractor is ``models.inception`` on ``--device``
(the card by default), its weights from ``SDBC_INCEPTION_WEIGHTS``
(``eval.fid.default_params``).

    python -m sdbc_tpu_torch.cli.precalc_fid_stats --data_root ./data \\
        --out ./fid_stats.npz
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from sdbc_tpu_torch.cli import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", type=str, default="./")
    p.add_argument("--csv_name", type=str, default="df_test.csv")
    p.add_argument("--num_imgs", type=int, default=4000)
    common.add_img_size_arg(p)
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--out", type=str, default="./fid_stats.npz")
    common.bool_flag(p, "tiny", False, "tiny Inception config (tests)")
    common.add_device_arg(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    common.resolve_img_size(args)
    device = common.resolve_device(args)
    import pandas as pd

    from sdbc_tpu_torch.eval.fid import (activation_statistics_from_files,
                                         default_params)
    from sdbc_tpu_torch.models.inception import InceptionConfig

    df = pd.read_csv(os.path.join(args.data_root, args.csv_name), index_col=0)
    image_dir = os.path.join(args.data_root, "images", "images")
    files = [os.path.join(image_dir, f"{idx}.jpg")
             for idx in df.index[: args.num_imgs]]
    files = [f for f in files if os.path.exists(f)]
    print(f"computing FID stats over {len(files)} images")

    cfg = InceptionConfig.tiny() if args.tiny else InceptionConfig.fid()
    model = default_params(cfg, device=device)
    mu, sigma = activation_statistics_from_files(
        files, model, batch_size=args.batch_size, image_size=args.img_size,
        verbose=True)
    np.savez(args.out, mu=mu, sigma=sigma)
    print(f"saved {args.out}: mu {mu.shape}, sigma {sigma.shape}")


if __name__ == "__main__":
    main()
