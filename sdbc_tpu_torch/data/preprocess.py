"""Goodreads dataset preprocessing (counterpart of
``sdbc_tpu/data/preprocess.py``), a host tool: the reference notebook
Data_preprocessing.ipynb as functions.

  1. drop rows whose cover image does not decode (a full decode:
     ``data/native_loader.py``'s probe, PIL where the library does not
     build, ``utils/png.py`` for PNGs)
  2. keep [book_authors, book_desc, book_title], drop NaN rows
  3. non-English filter: keep-ratio of [ascii-ish chars] / len ≥ threshold
     (0.97 in the notebook) — dropped rows exported for inspection
  4. split the LAST n_test rows as df_test.csv, the rest df_train.csv
  5. optional --reverify: repeat the readability check on both splits

pandas is imported inside ``preprocess`` (the CSVs are read and written
with it, as in the JAX package).
"""
from __future__ import annotations

import os
import re
from typing import Tuple

KEEP_COLUMNS = ["book_authors", "book_desc", "book_title"]
# characters considered "English-ish" (letters, digits, common punctuation)
_EN_CHARS = re.compile(r"[A-Za-z0-9\s\.,;:'\"!\?\-\(\)&/]")


def english_keep_ratio(text: str) -> float:
    """Fraction of characters in the basic-English class (notebook cell 12)."""
    if not isinstance(text, str) or not text:
        return 0.0
    return len(_EN_CHARS.findall(text)) / len(text)


def readable_indices(df, image_dir: str, verbose: bool = False,
                     collect_sizes: bool = False):
    """Indices whose <index>.jpg decodes cleanly (a full decode);
    ``collect_sizes`` also returns each readable image's (W, H)."""
    from sdbc_tpu_torch.data.native_loader import probe_size

    good, sizes = [], []
    for i, idx in enumerate(df.index):
        wh = probe_size(os.path.join(image_dir, f"{idx}.jpg"))
        if wh is not None:
            good.append(idx)
            if collect_sizes:
                sizes.append(wh)
        if verbose and (i + 1) % 1000 == 0:
            print(f"\rimage check {i + 1}/{len(df)}", end="", flush=True)
    if verbose:
        print()
    if collect_sizes:
        return good, sizes
    return good


def preprocess(data_root: str, source_csv: str = "book_data.csv",
               n_test: int = 5000, english_threshold: float = 0.97,
               verbose: bool = True, reverify: bool = False) -> Tuple[str, str]:
    """Run the pipeline; writes df_train.csv / df_test.csv (and
    dropped_non_English.csv) in data_root and returns the two paths."""
    import pandas as pd

    df = pd.read_csv(os.path.join(data_root, source_csv), index_col=0)
    image_dir = os.path.join(data_root, "images", "images")

    good, sizes = readable_indices(df, image_dir, verbose, collect_sizes=True)
    df = df.loc[good]
    if verbose:
        print(f"readable images: {len(df)}")
        if sizes:
            import numpy as np

            arr = np.asarray(sizes, np.float64)
            print(f"image size: mean W {arr[:, 0].mean():.1f}, "
                  f"mean H {arr[:, 1].mean():.1f} "
                  f"(the notebook's cell-3 histogram summary)")

    df = df[[c for c in KEEP_COLUMNS if c in df.columns]].dropna()

    ratios = df["book_desc"].map(english_keep_ratio)
    dropped = df[ratios < english_threshold]
    df = df[ratios >= english_threshold]
    dropped.to_csv(os.path.join(data_root, "dropped_non_English.csv"))
    if verbose:
        print(f"english-filtered: kept {len(df)}, dropped {len(dropped)}")

    n_test = min(n_test, max(len(df) - 1, 0))
    df_test = df.iloc[len(df) - n_test:]
    df_train = df.iloc[: len(df) - n_test]

    if reverify:
        for name, part in (("train", df_train), ("test", df_test)):
            ok = readable_indices(part, image_dir)
            if len(ok) < len(part):
                if verbose:
                    print(f"re-verify: dropping {len(part) - len(ok)} "
                          f"unreadable {name} rows")
                if name == "train":
                    df_train = part.loc[ok]
                else:
                    df_test = part.loc[ok]

    train_path = os.path.join(data_root, "df_train.csv")
    test_path = os.path.join(data_root, "df_test.csv")
    df_train.to_csv(train_path)
    df_test.to_csv(test_path)
    if verbose:
        print(f"split: {len(df_train)} train / {len(df_test)} test")
    return train_path, test_path
