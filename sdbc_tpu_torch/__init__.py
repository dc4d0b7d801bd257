"""sdbc_tpu_torch — the PyTorch/CUDA port of ``sdbc_tpu`` for NVIDIA Hopper.

Mirrors the JAX package's module paths (``ops/nn.py`` ↔ ``sdbc_tpu/ops/nn.py``
and so on) so each counterpart is easy to find.  The port imports ``torch``
and never ``jax``, nor anything of ``sdbc_tpu``: it runs where only it is
installed.

Covered so far: SD-1.5 sampling with every scheduler and option of the
JAX package's ``sample`` (``diffusion.pipeline.SDPipeline``, with
``generate``/``hires`` and the batch buckets), the fine-tuning step, the
FID stack (``models.inception``, ``eval.fid``) and the evaluation CLIs
(``python -m sdbc_tpu_torch.cli.inference``, ``.precalc_fid_stats``,
``.fid``), on hand-written ``sm_90a`` kernels (``csrc/``) for every Pallas
kernel of the JAX package.
"""
