"""CLIPScore CLI (counterpart of ``sdbc_tpu/cli/clip_score.py``): score
generated covers against their book prompts, on the card unless
``--device cpu``.

Scores every ``<row-id>.jpg/png`` in --images_dir (the ``get_fid_images``
naming, ``eval/generate.py``) against its df_test row's "TITLE by AUTHOR"
text, prints the mean and writes a per-image CSV next to the images.

    python -m sdbc_tpu_torch.cli.clip_score --images_dir generated/ \\
        --data_root dataset/ --clip_ckpt openai-clip-vit-base-patch32/

--clip_ckpt is a transformers CLIPModel save dir (both towers and the two
projections).  Without it a random tiny CLIP runs the plumbing and says so.
The csv is read without pandas (``data.dataset.read_csv_rows``); PIL is
imported only to read the images.
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np

from sdbc_tpu_torch.cli import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images_dir", type=str, required=True)
    p.add_argument("--data_root", type=str, default="./")
    p.add_argument("--csv_name", type=str, default="df_test.csv")
    p.add_argument("--clip_ckpt", type=str, default="",
                   help="transformers CLIPModel dir; empty = random-init "
                        "tiny model (plumbing only, meaningless scores)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--out_csv", type=str, default="",
                   help="per-image scores CSV (default "
                        "<images_dir>/clip_scores.csv)")
    common.add_device_arg(p)
    return p


def _scorer(args, device):
    import dataclasses

    import torch

    from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer
    from sdbc_tpu_torch.eval.clip_score import ClipModel, ClipScorer
    from sdbc_tpu_torch.models.clip import CLIPTextConfig, CLIPVisionConfig

    if args.clip_ckpt:
        from sdbc_tpu_torch.models.port import clip_model_from_dir

        tree, tcfg, vcfg = clip_model_from_dir(args.clip_ckpt)
        tok = (CLIPTokenizer.from_pretrained(args.clip_ckpt)
               if os.path.exists(os.path.join(args.clip_ckpt, "vocab.json"))
               else CLIPTokenizer.fallback(tcfg.vocab_size))
        return ClipScorer(tree, tcfg, vcfg, tok, device=device)
    print("WARNING: no --clip_ckpt — random-init tiny CLIP, scores "
          "are MEANINGLESS (plumbing/smoke only)", flush=True)
    tcfg = dataclasses.replace(CLIPTextConfig.tiny(), projection_dim=16)
    vcfg = CLIPVisionConfig.tiny()
    gen = torch.Generator(device=device).manual_seed(0)
    model = ClipModel(tcfg, vcfg, device=device, generator=gen)
    return ClipScorer(model, tcfg, vcfg,
                      CLIPTokenizer.fallback(tcfg.vocab_size))


def main(argv=None):
    from PIL import Image

    from sdbc_tpu_torch.data.dataset import read_csv_rows

    args = build_parser().parse_args(argv)
    scorer = _scorer(args, common.resolve_device(args))

    # the first row of each index value, as df.loc finds it
    rows = {}
    for idx, row in read_csv_rows(os.path.join(args.data_root,
                                               args.csv_name)):
        rows.setdefault(idx, row)
    files = sorted(f for f in os.listdir(args.images_dir)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))
    pairs = []
    for f in files:
        stem = os.path.splitext(f)[0]
        try:
            row = rows[int(stem)]
        except (ValueError, KeyError):
            continue
        pairs.append((f, f"{row['book_title']} by {row['book_authors']}"))
    if not pairs:
        raise SystemExit(f"no <row-id>.jpg images matching {args.csv_name} "
                         f"rows under {args.images_dir}")

    scores = []
    for i in range(0, len(pairs), args.batch_size):
        chunk = pairs[i:i + args.batch_size]
        imgs = np.stack([
            np.asarray(Image.open(os.path.join(args.images_dir, f))
                       .convert("RGB"), np.float32) / 255.0
            for f, _ in chunk])
        scores.extend(scorer.score(imgs, [t for _, t in chunk]).tolist())
        print(f"[clip_score] {min(i + args.batch_size, len(pairs))}"
              f"/{len(pairs)}", flush=True)

    out_csv = args.out_csv or os.path.join(args.images_dir,
                                           "clip_scores.csv")
    # csv.writer: real titles hold double quotes and commas
    with open(out_csv, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["file", "prompt", "clip_score"])
        for (f, t), s in zip(pairs, scores):
            w.writerow([f, t, f"{s:.6f}"])
    mean = float(np.mean(scores))
    print(f"CLIPScore mean over {len(scores)} images: {mean:.4f} "
          f"(per-image: {out_csv})")
    return mean


if __name__ == "__main__":
    main()
