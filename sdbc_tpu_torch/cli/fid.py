"""Standalone FID CLI (counterpart of ``sdbc_tpu/cli/fid.py``; the
reference's fid.py:321-335).

    python -m sdbc_tpu_torch.cli.fid path/to/generated path/to/real_or_stats.npz
"""
from __future__ import annotations

import argparse
import os

from sdbc_tpu_torch.cli import common


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("paths", type=str, nargs=2,
                   help="two image dirs or .npz stats files")
    p.add_argument("--batch_size", type=int, default=50)
    common.add_img_size_arg(p)
    p.add_argument("--inception_weights", type=str, default="",
                   help="pt_inception-2015-12-05*.pth (pytorch-fid) or "
                        "ported .npz — same resolution as "
                        "SDBC_INCEPTION_WEIGHTS")
    common.bool_flag(p, "tiny", False, "tiny Inception config (tests)")
    common.add_device_arg(p)
    args = p.parse_args(argv)
    common.resolve_img_size(args)
    device = common.resolve_device(args)
    if args.inception_weights:
        os.environ["SDBC_INCEPTION_WEIGHTS"] = args.inception_weights

    from sdbc_tpu_torch.eval.fid import calculate_fid_given_paths, default_params
    from sdbc_tpu_torch.models.inception import InceptionConfig

    cfg = InceptionConfig.tiny() if args.tiny else InceptionConfig.fid()
    # lazy: two .npz stats need no Inception weights (and no random-init
    # warning) — the model only resolves when an image dir is featurized
    fid = calculate_fid_given_paths(
        tuple(args.paths), model=lambda: default_params(cfg, device=device),
        batch_size=args.batch_size, image_size=args.img_size, verbose=True)
    print(f"FID: {fid:.4f}")


if __name__ == "__main__":
    main()
