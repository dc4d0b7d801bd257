"""Seeded randomness (counterpart of ``sdbc_tpu/utils/prng.py``)."""
from __future__ import annotations

import numpy as np
import torch

GLOBAL_SEED = 42  # reference default


def per_sample_fixed_latents(n: int, shape, seed: int = GLOBAL_SEED) -> np.ndarray:
    """n fixed latents, each drawn sequentially from one seeded CPU generator.

    ``generator.manual_seed(seed)`` once, then one ``torch.randn(shape)`` per
    sample, stacked — NCHW numpy, bit-identical to the JAX package's
    torch-generator branch.
    """
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    lat = [torch.randn(*shape, generator=g, dtype=torch.float32).numpy()
           for _ in range(n)]
    return np.stack(lat).astype(np.float32)
