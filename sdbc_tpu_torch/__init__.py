"""sdbc_tpu_torch — the PyTorch/CUDA port of ``sdbc_tpu`` for NVIDIA Hopper.

Mirrors the JAX package's module paths (``ops/nn.py`` ↔ ``sdbc_tpu/ops/nn.py``
and so on) so each counterpart is easy to find.  The port imports ``torch``
and never ``jax``, nor anything of ``sdbc_tpu``: it runs where only it is
installed.

Slice covered so far: SD-1.5 text → image with DDIM, classifier-free
guidance and the VAE decode (``diffusion.pipeline.SDPipeline``), with
hand-written ``sm_90a`` kernels (``csrc/``) for the fixed-cap inference
flash attention and the fused GEGLU feed-forward.
"""
