"""The fine-tuning step of SD-1.x, SD-2.x and SDXL (counterpart of
``sdbc_tpu/train/trainer.py``) on one device: full fine-tuning, LoRA,
textual inversion, prior preservation, cached latents and ControlNet
training.

  - one step = a Python loop over the micro-batches of a
    (grad_accum, micro, ...) batch: VAE encode (no gradient; image by image
    at 512²-class sizes with a batch > 1), posterior sample ×
    scaling_factor in fp32, noise (+ offset noise) and a uniform timestep,
    DDPM add_noise, CLIP encode, UNet eps- or v-prediction, fp32
    per-example MSE with optional min-SNR weighting (÷ SNR for eps,
    ÷ (SNR + 1) for v); gradients summed in fp32, divided by grad_accum,
    then ONE optimizer update;
  - SDXL (``cfg.clip2``; ``dual_text_encoder``): the dual-encoder context
    and the text-time embedding of the pooled bigG output and the
    micro-conditioning ids (S, S, 0, 0, S, S), S the image side recovered
    from the latent grid (the refiner: (S, S, 0, 0, 6.0), bigG alone;
    ``refiner``); each micro-batch carries ``input_ids_2`` from the second
    tokenizer, and ``train_text_encoder`` trains both encoders;
  - trainable components (``train_unet`` / ``train_text_encoder``) are fp32
    masters; frozen ones are cast to the compute dtype;
  - the optimizer: optax's cosine decay (lr read at ``count``, before the
    increment), optional clip-by-global-norm, AdamW with fp32 moments or
    8-bit moments (``train.adam8bit``), under the ``apply_if_finite`` guard
    (non-finite gradients skip the update and leave the inner state and
    ``count`` as they were);
  - the warm-up-ramped EMA of the trainable parameters when
    ``ema_decay > 0``.

On CUDA the UNet's spatial self-attention runs the training flash kernels
(forward + both backward kernels) and the 8-bit optimizer runs the fused
AdamW kernel once per leaf with ≥ ``min_8bit_size`` elements, leaves as
the JAX tree has them (``optimizer_leaves``: the text encoders' layers
and a deep transformer's blocks stacked).  ``grad_ckpt`` checkpoints the
UNet (``unet.apply``'s ``remat``, granularity ``remat_mode``: "block" or
"selective"), as the reference's gradient checkpointing does.  PyTorch
updates in place: the state's modules and moments are changed by ``step``,
and ``init_train_state`` takes ownership of the modules it is given.

Randomness comes from an explicit ``torch.Generator`` or from injected
``draws`` (per micro-batch ``eps``, ``noise``, ``t`` and, with noise
offset, ``offset``): the JAX package's ``jax.random`` streams cannot be
reproduced here, so the parity tests hand the JAX draws over.

Parameter-efficient modes, as the JAX package has them:

  - LoRA (``lora_rank``): every component frozen in the compute dtype;
    the trainable tree is ``{"lora": {path: {"a", "b"}}}`` (fp32).  Each
    micro-batch puts W + (α/r)·a @ b (``lora.merged_weights``) in place of
    the adapted frozen weights for its forward AND its backward
    (``merged``): under gradient checkpointing the backward recomputes the
    forward, and must see the merged weights again, which
    ``torch.func.functional_call`` (restoring on return) would not give.
  - textual inversion (``ti_token``): the trainable tree is
    ``{"ti": {"rows": (ti_vectors, hidden)}}`` (SDXL: also ``"rows2"``,
    the second encoder's rows at the same appended ids), appended to the
    frozen embedding tables the same way.
  - prior preservation (``prior_weight``): each micro-batch carries
    ``prior_pixel_values``/``prior_input_ids`` (SDXL:
    ``prior_input_ids_2``); one VAE encode and one
    UNet call on the concatenated batch, loss = instance mean +
    prior_weight · prior mean.
  - cached latents: a micro-batch with ``latent_mean``/``latent_logvar``
    (``train/latent_cache.py``) samples mean + exp(½·logvar)·eps with no
    VAE encode.
  - ControlNet (``train_controlnet``, arXiv:2302.05543): the one branch
    ``models["controlnet"]`` trains (fp32 masters), every base component
    frozen in the compute dtype.  The hint comes from the micro-batch's
    pixels (``control_hint``: "edges" the Sobel magnitude, "image" the
    image), then ``embed_cond``, the branch's forward (checkpointed by
    ``grad_ckpt``) and the base UNet with its residuals.  The residuals
    enter the base's skips and mid output only, so autograd's backward
    runs through the branch and the base's up path.

The optimizer's leaves are in the JAX tree's leaf order for the adapters
(sorted paths, then a, b) and in module order for full components
(``optimizer_leaf_keys`` names each leaf by its JAX key path, so
``utils/checkpoint.py`` writes the state in the JAX layout).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from sdbc_tpu_torch.diffusion import schedulers as sched_mod
from sdbc_tpu_torch.diffusion.graph import (PipelineConfig, encode_text_xl,
                                            xl_added_cond)
from sdbc_tpu_torch.models import clip as clip_mod
from sdbc_tpu_torch.models import controlnet as cn_mod
from sdbc_tpu_torch.models.convert import STACKED_INDEX
from sdbc_tpu_torch.models import unet as unet_mod
from sdbc_tpu_torch.models import vae as vae_mod
from sdbc_tpu_torch.train.adam8bit import AdamW8bit, leaf_parts
from sdbc_tpu_torch.utils.dtypes import cast_floating


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # the JAX package's defaults (reference finetune_sd.py:25-48)
    learning_rate: float = 5e-6
    weight_decay: float = 1e-4
    num_examples: int = 12000    # cosine horizon in optimizer steps
    eta_min: float = 1e-6
    grad_accum: int = 16
    micro_batch: int = 1         # lr scaling only
    train_unet: bool = False
    train_text_encoder: bool = True
    grad_ckpt: bool = False
    # "block" = checkpoint whole ResBlocks/transformers (reference
    # semantics); "selective" = keep the attention outside the checkpoint
    # regions (models/unet.py)
    remat_mode: str = "block"
    use_8bit_adam: bool = False
    max_grad_norm: float = 0.0   # 0 = off
    lr_scale_by_dp: bool = False
    min_snr_gamma: float = 0.0
    noise_offset: float = 0.0
    ema_decay: float = 0.0
    # LoRA: rank > 0 trains adapters of the selected components' attention
    # projections, ΔW = (alpha/rank)·a @ b (train/lora.py)
    lora_rank: int = 0
    lora_alpha: float = 8.0
    # textual inversion: a non-empty token trains only ti_vectors rows
    # appended to the CLIP table (train/textual_inversion.py)
    ti_token: str = ""
    ti_vectors: int = 1
    # prior preservation: > 0 weights the class batch's MSE
    # (train/prior.py)
    prior_weight: float = 0.0
    # ControlNet: train only the branch models["controlnet"] (needs
    # cfg.controlnet), the base frozen; the hint from the pixel batch
    train_controlnet: bool = False
    control_hint: str = "edges"        # "edges" (Sobel) | "image"
    # SDXL (cfg.clip2 set): train_text_encoder covers both encoders, and
    # each batch carries input_ids_2; must agree with the PipelineConfig
    # given to make_train_step (the finetune CLI sets it from cfg.is_sdxl)
    dual_text_encoder: bool = False
    # the SDXL refiner (cfg.refiner): bigG alone and the aesthetic
    # micro-conditioning; implies dual_text_encoder
    refiner: bool = False

    def __post_init__(self):
        if self.remat_mode not in ("block", "selective"):
            raise ValueError(f"unknown remat_mode {self.remat_mode!r}")

    @property
    def lora_scale(self) -> float:
        return self.lora_alpha / self.lora_rank

    def trainable_keys(self):
        if self.train_controlnet:
            # the paper's protocol: every base component stays frozen
            return ("controlnet",)
        keys = []
        if self.train_unet:
            keys.append("unet")
        if self.train_text_encoder:
            if not self.refiner:  # a refiner has no first encoder
                keys.append("text_encoder")
            if self.dual_text_encoder:
                keys.append("text_encoder_2")
        return tuple(keys)


@dataclasses.dataclass
class TrainState:
    # fp32 masters being optimised: {component: module}, or the adapter
    # trees {"lora": {path: {"a", "b"}}} / {"ti": {"rows": tensor}}
    trainable: Dict[str, Any]
    frozen: Dict[str, torch.nn.Module]      # compute-dtype frozen components
    opt_state: Any
    step: int = 0
    ema: Optional[Dict[str, Any]] = None    # shadow of trainable


def _grouped_leaves(trainable: Dict[str, Any]):
    """{leaf id: (a parameter name or adapter key, [tensors])} of the
    optimizer's leaves, in order: an adapter's tensors in the JAX tree's
    order (sorted paths, then a, b); the TI rows (``rows``, then SDXL's
    ``rows2``); a component's parameters in module order, a tower's
    ``layers.<i>.<name>`` (a deep transformer's ``blocks.<k>.<name>``)
    gathered into one leaf of that name in every layer, in layer order
    (the JAX tree stacks them into one array per name)."""
    if "lora" in trainable:
        lora = trainable["lora"]
        return {(path, x): ((path, x), [lora[path][x]])
                for path in sorted(lora) for x in "ab"}
    if "ti" in trainable:
        return {r: (r, [trainable["ti"][r]])
                for r in ("rows", "rows2") if r in trainable["ti"]}
    leaves: dict = {}
    for k in sorted(trainable):
        for name, p in trainable[k].named_parameters():
            group = (k, STACKED_INDEX.sub(r"\1\2.", name))
            leaves.setdefault(group, (name, []))[1].append(p)
    return leaves


def optimizer_leaves(trainable: Dict[str, Any]) -> List[List[torch.Tensor]]:
    """The optimizer's leaves, each a list of tensors (``_grouped_leaves``)."""
    return [ts for _, ts in _grouped_leaves(trainable).values()]


def optimizer_leaf_keys(trainable: Dict[str, Any]) -> list:
    """The JAX key path of each of ``optimizer_leaves``' leaves."""
    from sdbc_tpu_torch.models.convert import jax_key

    if "lora" in trainable:
        return [(("lora", False), (path, False), (x, False))
                for (path, x), _ in _grouped_leaves(trainable).values()]
    if "ti" in trainable:
        return [(("ti", False), (r, False)) for r in _grouped_leaves(trainable)]
    return [((k, False),) + jax_key(trainable[k], name)
            for (k, _), (name, _) in _grouped_leaves(trainable).items()]


def trainable_params(trainable: Dict[str, Any]) -> List[torch.Tensor]:
    """Every trainable tensor: the trainable components' parameters
    (components by name, then module order), or the adapter's tensors."""
    if "lora" in trainable or "ti" in trainable:
        return _flat(optimizer_leaves(trainable))
    return [p for k in sorted(trainable) for p in trainable[k].parameters()]


def _split_params(models: Dict[str, torch.nn.Module], tcfg: TrainConfig,
                  compute_dtype, device, generator=None, ti_init_ids=None):
    tkeys = tcfg.trainable_keys()
    if tcfg.refiner and tcfg.ti_token:
        raise ValueError(
            "textual inversion is not wired for the refiner flavor (its "
            "single-bigG conditioning has no base-model counterpart to "
            "compose the token into) — invert on the base model instead")
    if tcfg.train_controlnet:
        if tcfg.lora_rank > 0 or tcfg.ti_token:
            raise ValueError("train_controlnet is a full-branch mode; it "
                             "cannot combine with lora_rank/ti_token")
        if tcfg.train_unet or tcfg.train_text_encoder:
            raise ValueError(
                "train_controlnet freezes the whole base model (the "
                "arXiv:2302.05543 protocol) — unset train_unet/"
                "train_text_encoder rather than having them silently ignored")
        if "controlnet" not in models:
            raise ValueError(
                "train_controlnet needs models['controlnet'] — attach one "
                "with models.controlnet.from_unet(models['unet'], ...) or "
                "port a checkpoint (models/port.load_controlnet)")
        if isinstance(models["controlnet"], (list, tuple)):
            raise ValueError(
                "train_controlnet trains ONE branch (multi-ControlNet is a "
                "serving composition — residuals sum at sampling time); "
                "train branches separately and attach them together with "
                "a comma-separated --controlnet_path")
    if tcfg.ti_token or tcfg.lora_rank > 0:
        # every component freezes; the trainable tree is the adapter
        if tcfg.ti_token and tcfg.lora_rank > 0:
            raise ValueError("ti_token and lora_rank are mutually exclusive")
        if tcfg.ti_token:
            from sdbc_tpu_torch.train import textual_inversion as ti_mod

            # SDXL: the placeholder sits at the same appended ids in both
            # tokenizers, each encoder learns its own rows for them
            tables = (("rows", "text_encoder"),) + (
                (("rows2", "text_encoder_2"),) if tcfg.dual_text_encoder
                else ())
            trainable = {"ti": {
                r: ti_mod.init_rows(
                    models[comp].token_embedding.weight.detach(),
                    tcfg.ti_vectors, init_ids=ti_init_ids)
                .to(device).requires_grad_(True) for r, comp in tables}}
        else:
            from sdbc_tpu_torch.train import lora as lora_mod

            if generator is None:
                generator = torch.Generator().manual_seed(0)
            lora = lora_mod.init_lora(generator, models, tcfg.lora_rank,
                                      components=tkeys)
            trainable = {"lora": {
                k: {x: v.to(device, torch.float32).requires_grad_(True)
                    for x, v in ab.items()} for k, ab in lora.items()}}
        frozen = {k: cast_floating(m.to(device), compute_dtype)
                  .requires_grad_(False) for k, m in models.items()}
        return trainable, frozen
    trainable = {k: models[k].to(device, torch.float32).requires_grad_(True)
                 for k in tkeys}
    frozen = {k: cast_floating(m.to(device), compute_dtype).requires_grad_(False)
              for k, m in models.items() if k not in tkeys}
    return trainable, frozen


# ---------------------------------------------------------------------------
# optimizer


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """optax's cosine_decay_schedule, in fp32:
    init·((1−α)·½(1+cos(π·min(t, T)/T)) + α)."""
    f = np.float32

    def schedule(count: int) -> float:
        t = min(f(count), f(decay_steps))
        cosine = f(0.5) * (f(1) + np.cos(f(np.pi) * t / f(decay_steps)))
        return float(f(init_value) * ((f(1) - f(alpha)) * cosine + f(alpha)))

    return schedule


def _bias_correction(decay: float, count: int) -> float:
    """1 − decay**count in fp32, as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


@dataclasses.dataclass
class AdamState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def _flat(leaves) -> List[torch.Tensor]:
    return [t for leaf in leaves for t in leaf_parts(leaf)]


class AdamW:
    """optax.adamw with fp32 moments over a list of leaves, updating the
    parameters in place (elementwise, so a stacked leaf's parts are
    updated one by one)."""

    def __init__(self, learning_rate: Callable[[int], float], b1=0.9,
                 b2=0.999, eps=1e-8, weight_decay=1e-4):
        self.schedule = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params) -> AdamState:
        from sdbc_tpu_torch.parallel.shard import mark_like

        params = _flat(params)
        z = lambda p: mark_like(torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), p)
        return AdamState(0, [z(p) for p in params], [z(p) for p in params])

    @torch.no_grad()
    def update(self, grads, state: AdamState, params) -> AdamState:
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        lr = float(self.schedule(state.count))
        bc1, bc2 = (_bias_correction(b, count) for b in (b1, b2))
        for g, p, mu, nu in zip(_flat(grads), _flat(params), state.mu,
                                state.nu):
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * (g * g))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.add_(u * (-lr))
        state.count = count
        return state


@dataclasses.dataclass
class OptState:
    inner: Any
    notfinite_count: int = 0   # consecutive skipped updates
    last_finite: bool = True
    total_notfinite: int = 0   # cumulative skipped updates


class Optimizer:
    """clip-by-global-norm (optional) → AdamW, under optax's
    ``apply_if_finite``: non-finite gradients skip the update."""

    def __init__(self, inner, max_grad_norm: float = 0.0, mesh=None):
        self.inner = inner
        self.max_grad_norm = max_grad_norm
        self.mesh = mesh

    def init(self, params) -> OptState:
        return OptState(inner=self.inner.init(params))

    @torch.no_grad()
    def update(self, grads, state: OptState, params) -> OptState:
        """``grads`` and ``params``: lists of leaves (``optimizer_leaves``).
        Under a mesh the finite flag and the global norm are reduced over
        the ranks, so every rank takes the same decision."""
        flags = [torch.isfinite(g).all() for g in _flat(grads)]
        finite = bool(torch.stack(flags).all()) if flags else True
        if self.mesh is not None:
            finite = _all_finite(finite, self.mesh)
        state.last_finite = finite
        if not finite:
            state.notfinite_count += 1
            state.total_notfinite += 1
            return state
        state.notfinite_count = 0
        if self.max_grad_norm > 0:
            norm = (torch.sqrt(sum(torch.sum(g.float() ** 2)
                                   for g in _flat(grads)))
                    if self.mesh is None
                    else _sharded_norm(_flat(grads), _flat(params),
                                       self.mesh))
            if not bool(norm < self.max_grad_norm):
                grads = [[g / norm * self.max_grad_norm
                          for g in leaf_parts(leaf)] for leaf in grads]
        state.inner = self.inner.update(grads, state.inner, params)
        return state


def _all_finite(finite: bool, mesh) -> bool:
    """Whether every rank's gradients are finite."""
    from sdbc_tpu_torch.parallel import comm
    from sdbc_tpu_torch.parallel.mesh import mesh_device

    bad = comm.all_reduce_scalars([0.0 if finite else 1.0], None,
                                  device=mesh_device(mesh))
    return bad[0] == 0.0


def _sharded_norm(grads, params, mesh):
    """The global norm of gradients some of which are shards: each
    tensor's squares summed over the groups its parameter is sharded
    over (``model`` for TP, ``data`` for FSDP), replicated ones once."""
    from sdbc_tpu_torch.parallel import comm
    from sdbc_tpu_torch.parallel.shard import info

    acc = {}
    for g, p in zip(grads, params):
        i = info(p)
        key = (i is not None and i.tp is not None,
               i is not None and i.fsdp is not None)
        acc[key] = acc.get(key, 0.0) + torch.sum(g.float() ** 2)
    dev = grads[0].device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for (on_model, on_data) in ((False, False), (True, False),
                                (False, True), (True, True)):
        x = torch.as_tensor(acc.get((on_model, on_data), 0.0),
                            dtype=torch.float32, device=dev).clone()
        if on_model:
            comm.all_reduce_(x, mesh.get_group("model"))
        if on_data:
            comm.all_reduce_(x, mesh.get_group("data"))
        total = total + x
    return torch.sqrt(total)


def make_optimizer(tcfg: TrainConfig, dp_size: int = 1,
                   mesh=None) -> Optimizer:
    # the reference's opt-in scale_lr: lr × grad_accum × batch size ×
    # data-parallel ranks
    scale = (tcfg.grad_accum * tcfg.micro_batch * dp_size
             if tcfg.lr_scale_by_dp else 1)
    lr = tcfg.learning_rate * scale
    if lr > 0:
        schedule = cosine_decay_schedule(lr, max(tcfg.num_examples, 1),
                                         tcfg.eta_min / lr)
    else:
        schedule = lambda _: 0.0
    if tcfg.use_8bit_adam:
        inner = AdamW8bit(schedule, b1=0.9, b2=0.999, eps=1e-8,
                          weight_decay=tcfg.weight_decay)
    else:
        inner = AdamW(schedule, b1=0.9, b2=0.999, eps=1e-8,
                      weight_decay=tcfg.weight_decay)
    return Optimizer(inner, tcfg.max_grad_norm, mesh=mesh)


# ---------------------------------------------------------------------------
# state


def init_train_state(models: Dict[str, torch.nn.Module], tcfg: TrainConfig,
                     compute_dtype=torch.bfloat16,
                     device="cuda", generator=None,
                     ti_init_ids=None, dp_size: int = 1) -> TrainState:
    """``models``: {"text_encoder", "unet", "vae"} modules, moved to
    ``device`` in place (the trainable ones as fp32 masters, the frozen
    ones cast to ``compute_dtype``).  ``generator`` draws the LoRA a-init
    (b is zero, so the adapted model is the base at step 0);
    ``ti_init_ids``: the ids of textual inversion's initializer word;
    ``dp_size``: data-parallel ranks (``lr_scale_by_dp``).  TP/FSDP cut
    the state afterwards (``shard_train_state``)."""
    if not tcfg.trainable_keys() and not tcfg.ti_token:
        raise ValueError(
            "nothing to train: set train_unet and/or train_text_encoder")
    trainable, frozen = _split_params(models, tcfg, compute_dtype,
                                      torch.device(device), generator,
                                      ti_init_ids)
    opt = make_optimizer(tcfg, dp_size)
    ema = None
    if tcfg.ema_decay > 0:
        if "lora" in trainable or "ti" in trainable:
            raise ValueError("ema_decay with lora_rank or ti_token: a "
                             "checkpoint's ema/ overlay holds component "
                             "trees, not adapters")
        ema = {k: copy.deepcopy(m).requires_grad_(False)
               for k, m in trainable.items()}
    return TrainState(trainable=trainable, frozen=frozen,
                      opt_state=opt.init(optimizer_leaves(trainable)),
                      step=0, ema=ema)


def shard_train_state(state: TrainState, mesh, *, tp: bool = False,
                      fsdp: bool = False, exclude: tuple = (),
                      min_size: int = 2 ** 12) -> dict:
    """Cut a full-component state to this rank's part in place: the
    trainable and frozen components and the EMA shadow by the JAX
    package's ``tp_specs`` (``exclude``: from ``validate_tp``) and/or
    ``fsdp_specs``, and the fp32 AdamW moments as their parameters.  Call
    it after any resume restore (every rank reads the full trees and keeps
    its shard).  Returns the {path: spec} applied."""
    from sdbc_tpu_torch.parallel import shard as shard_mod
    from sdbc_tpu_torch.parallel.specs import _reject_int8_state

    if "lora" in state.trainable or "ti" in state.trainable:
        raise ValueError("TP/FSDP shard full components; the adapter "
                         "modes (LoRA, textual inversion) use plain data "
                         "parallelism")
    if tp or fsdp:
        _reject_int8_state(state.opt_state, "fsdp_specs" if fsdp
                           else "tp_specs")
    params_before = _flat(optimizer_leaves(state.trainable))
    models = {**state.frozen, **state.trainable}
    specs = shard_mod.shard_modules(models, mesh, tp=tp, fsdp=fsdp,
                                    exclude=exclude, min_size=min_size)
    if state.ema is not None:
        shard_mod.shard_modules(state.ema, mesh, specs=specs)
    inner = state.opt_state.inner
    if isinstance(inner, AdamState):
        for i, p in enumerate(params_before):
            for moments in (inner.mu, inner.nu):
                moments[i] = shard_mod.mark_like(
                    shard_mod.shard_like(moments[i], p).contiguous()
                    .clone(), p)
    return specs


def _ema_pairs(state: TrainState):
    """(shadow, master) parameter pairs of the EMA."""
    return [(e, p) for k in state.ema
            for e, p in zip(state.ema[k].parameters(),
                            state.trainable[k].parameters())]


@contextlib.contextmanager
def _swapped(pairs):
    """Each (module, tensor) pair's tensor in place of the module's
    ``weight`` for the block (the registered parameter put back after
    it, whatever happens inside)."""
    saved = [(m, m._parameters["weight"]) for m, _ in pairs]
    try:
        for m, w in pairs:
            m._parameters["weight"] = w
        yield
    finally:
        for m, w in saved:
            m._parameters["weight"] = w


@contextlib.contextmanager
def merged(trainable: Dict[str, Any], frozen: Dict[str, torch.nn.Module],
           tcfg: TrainConfig):
    """The {text_encoder, unet, vae} modules of a state's halves for a
    forward and its backward: the trainable components over the frozen
    ones; or the frozen modules with the LoRA-merged projections or the
    extended embedding table in place, differentiable in the adapter."""
    if "ti" in trainable:
        pairs = []
        for r, comp in (("rows", "text_encoder"), ("rows2", "text_encoder_2")):
            if r in trainable["ti"]:
                emb = frozen[comp].token_embedding
                rows = trainable["ti"][r].to(emb.weight.dtype)
                pairs.append((emb, torch.cat([emb.weight, rows], dim=0)))
        with _swapped(pairs):
            yield frozen
    elif "lora" in trainable:
        from sdbc_tpu_torch.train import lora as lora_mod

        with _swapped(lora_mod.merged_weights(frozen, trainable["lora"],
                                              tcfg.lora_scale)):
            yield frozen
    else:
        out = dict(frozen)
        out.update(trainable)
        yield out


def merged_params(state: TrainState, tcfg: Optional[TrainConfig] = None,
                  use_ema: bool = False) -> Dict[str, torch.nn.Module]:
    """{text_encoder, unet, vae} modules for inference or checkpointing:
    a LoRA state merged into copies of the touched components (needs
    ``tcfg`` for the scale), a textual-inversion state with a copy of the
    text encoder whose table holds the rows; ``use_ema`` serves the EMA
    shadow (raises without one)."""
    trainable = state.trainable
    if use_ema:
        if state.ema is None:
            raise ValueError("use_ema=True on a state with no EMA shadow "
                             "(train with TrainConfig.ema_decay > 0)")
        trainable = state.ema
    if "lora" in trainable:
        if tcfg is None or tcfg.lora_rank <= 0:
            raise ValueError("merged_params on a LoRA state needs the "
                             "TrainConfig (for the alpha/rank merge scale)")
        from sdbc_tpu_torch.train import lora as lora_mod

        return lora_mod.apply_lora(dict(state.frozen), trainable["lora"],
                                   tcfg.lora_scale)
    if "ti" in trainable:
        from sdbc_tpu_torch.train import textual_inversion as ti_mod

        rows2 = trainable["ti"].get("rows2")
        return ti_mod.merge(dict(state.frozen),
                            trainable["ti"]["rows"].detach(),
                            rows2=None if rows2 is None else rows2.detach())
    out = dict(state.frozen)
    out.update(trainable)
    return out


# ---------------------------------------------------------------------------
# loss and step


def _draw(draws: dict, name: str, generator, make):
    """The injected draw ``name``, else ``make(generator)``."""
    value = draws.get(name)
    if value is not None:
        return value
    if generator is None:
        raise ValueError(f"diffusion_loss needs a torch.Generator or an "
                         f"injected {name!r} draw")
    return make(generator)


def _prior_split(batch: dict, tcfg: TrainConfig):
    """(batch with the class batch appended, class rows) under prior
    preservation, else (batch, 0)."""
    if tcfg.prior_weight <= 0:
        return batch, 0
    prior = {k[len("prior_"):]: v for k, v in batch.items()
             if k.startswith("prior_")}
    if "input_ids" not in prior or ("pixel_values" in batch
                                    and "pixel_values" not in prior):
        raise ValueError(
            "prior_weight > 0 needs prior_pixel_values + prior_input_ids "
            "in every micro-batch (train/prior.py augment_loader); cached "
            "latents are not supported for the prior set")
    if "latent_mean" in batch:
        raise ValueError("prior_weight > 0 is incompatible with "
                         "--cache_latents (the class set has no latent "
                         "cache) — drop one of the two")
    n = prior["input_ids"].shape[0]
    return {k: torch.cat([v, prior[k]], dim=0) for k, v in batch.items()
            if not k.startswith("prior_")}, n


def _latent_shape(cfg: PipelineConfig, batch: dict, tcfg: TrainConfig) -> tuple:
    """The latents' shape of one micro-batch (class rows included)."""
    if "latent_mean" in batch:
        n, h, w, c = batch["latent_mean"].shape
    else:
        n, h, w, _ = batch["pixel_values"].shape
        h, w, c = h // cfg.vae_scale, w // cfg.vae_scale, cfg.latent_channels
    if tcfg.prior_weight > 0:
        n += batch["prior_input_ids"].shape[0]
    return (n, h, w, c)


def host_draws(generator: torch.Generator, cfg: PipelineConfig,
               tcfg: TrainConfig, batch: dict) -> List[dict]:
    """One step's draws (``diffusion_loss``'s eps, noise, offset, t per
    micro-batch, in that order) from a CPU ``generator``: the same values
    wherever the step runs."""
    return [_draw_set(generator, _latent_shape(
                cfg, {k: v[i] for k, v in batch.items()}, tcfg), cfg, tcfg)
            for i in range(tcfg.grad_accum)]


def _draw_set(generator: torch.Generator, shape: tuple, cfg: PipelineConfig,
              tcfg: TrainConfig) -> dict:
    """One micro-batch's draws for latents of ``shape``, in
    ``diffusion_loss``'s order, on the generator's device."""
    dev = generator.device
    d = {"eps": torch.randn(shape, generator=generator, device=dev),
         "noise": torch.randn(shape, generator=generator, device=dev)}
    if tcfg.noise_offset > 0:
        d["offset"] = torch.randn((shape[0], 1, 1, shape[-1]),
                                  generator=generator, device=dev)
    d["t"] = torch.randint(0, cfg.schedule.num_train_timesteps,
                           (shape[0],), generator=generator, device=dev)
    return d


def _local_draws(draws: Optional[dict], generator, mb: dict,
                 cfg: PipelineConfig, tcfg: TrainConfig, mesh) -> dict:
    """This rank's rows of a micro-batch's GLOBAL draws: the injected
    ones, else the global batch's drawn from ``generator`` (the one
    stream every rank draws alike).  ``mb`` holds the rank's rows; the
    global micro-batch is the data ranks' rows in order (with prior
    preservation: every rank's instance rows, then every rank's class
    rows, as the one-process batch has them)."""
    from sdbc_tpu_torch.parallel.mesh import (host_local_batch_indices,
                                              mesh_shape)

    n = mesh_shape(mesh)["data"]
    inst = mb["input_ids"].shape[0] * n
    rows = [host_local_batch_indices(inst, mesh)]
    if tcfg.prior_weight > 0:
        rows.append(inst + host_local_batch_indices(
            mb["prior_input_ids"].shape[0] * n, mesh))
    rows = np.concatenate(rows)
    if draws is None:
        if generator is None:
            raise ValueError("the data-parallel step needs a "
                             "torch.Generator or injected global draws")
        local = _latent_shape(cfg, mb, tcfg)
        draws = _draw_set(generator, (local[0] * n,) + local[1:], cfg, tcfg)
    return {k: v[torch.from_numpy(rows).to(v.device)]
            for k, v in draws.items()}


def _mean_over_data(grads, params, mesh) -> None:
    """The data-parallel gradient mean: an FSDP shard's gradient was
    summed over the data group by its reduce-scatter (or reduce) in the
    backward pass and only divides; the others take the bucketed mean
    all-reduce."""
    from sdbc_tpu_torch.parallel import comm
    from sdbc_tpu_torch.parallel.mesh import mesh_shape
    from sdbc_tpu_torch.parallel.shard import info

    n = mesh_shape(mesh)["data"]
    plain = []
    for g, p in zip(grads, params):
        i = info(p)
        if i is not None and i.fsdp is not None:
            g.div_(n)
        else:
            plain.append(g)
    comm.all_reduce_mean_(plain, mesh.get_group("data"))


def diffusion_loss(models, batch, cfg: PipelineConfig, tcfg: TrainConfig,
                   sched: sched_mod.Schedule, compute_dtype=torch.bfloat16,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[dict] = None):
    """Single-micro-batch denoising MSE (reference finetune_sd.py:460-483).

    ``batch``: "pixel_values" or the cached "latent_mean"/"latent_logvar",
    "input_ids" (SDXL: and "input_ids_2"), and under prior preservation
    "prior_pixel_values" / "prior_input_ids" (SDXL: "prior_input_ids_2";
    appended to the batch; ``draws`` cover both).
    ``draws``: {"eps", "noise", "t"} (+ "offset" with noise offset) for
    this micro-batch; otherwise they come from ``generator``."""
    dt = compute_dtype
    draws = draws or {}
    batch, prior_n = _prior_split(batch, tcfg)
    dev = batch["input_ids"].device
    normal = lambda shape: lambda g: torch.randn(
        shape, generator=g, device=dev, dtype=torch.float32)
    with torch.no_grad():
        if "latent_mean" in batch:
            # cached posterior moments (train/latent_cache.py): fp32 on
            # disk, cast back to the compute dtype
            mean = batch["latent_mean"].to(dt)
            logvar = batch["latent_logvar"].to(dt)
        else:
            pixels = batch["pixel_values"].to(dt)    # (B, H, W, 3) in [-1,1]
            vae = models["vae"]
            if vae_mod.prefer_chunked_encode(*pixels.shape[:3]):
                mean, logvar = vae_mod.encode_moments_chunked(vae, pixels)
            else:
                mean, logvar = vae_mod.encode_moments(vae, pixels)
        eps = _draw(draws, "eps", generator, normal(mean.shape))
        latents = vae_mod.sample(mean, logvar, eps=eps.to(dev))
        latents = (latents * cfg.vae.scaling_factor).float()
    bsz = latents.shape[0]
    noise = _draw(draws, "noise", generator, normal(latents.shape)).to(
        dev, torch.float32)
    if tcfg.noise_offset > 0:
        off = _draw(draws, "offset", generator,
                    normal((bsz, 1, 1, latents.shape[-1])))
        noise = noise + tcfg.noise_offset * off.to(dev, torch.float32)
    t = _draw(draws, "t", generator, lambda g: torch.randint(
        0, cfg.schedule.num_train_timesteps, (bsz,), generator=g,
        device=dev)).to(dev, torch.int64)
    noisy = sched_mod.ddpm_add_noise(sched, latents, noise, t).to(dt)

    added_cond = None
    if cfg.is_sdxl:
        ctx, added_cond = _xl_conditioning(models, batch, cfg, latents, dt)
    else:
        ctx = clip_mod.apply(models["text_encoder"], batch["input_ids"],
                             compute_dtype=dt)
    control = None
    if tcfg.train_controlnet:
        if cfg.controlnet is None:
            raise ValueError("train_controlnet needs cfg.controlnet "
                             "(PipelineConfig.with_controlnet)")
        if "pixel_values" not in batch:
            raise ValueError("train_controlnet derives its conditioning "
                             "hint from the pixel batch — incompatible "
                             "with cached latents")
        cn = models["controlnet"]
        hint = cn_mod.training_hint(batch["pixel_values"], tcfg.control_hint)
        control = cn_mod.apply(cn, noisy, t, ctx,
                               cn_mod.embed_cond(cn, hint.to(dt)),
                               remat=tcfg.grad_ckpt, attn_impl="auto",
                               added_cond=added_cond)
    pred = unet_mod.apply(models["unet"], noisy, t, ctx, attn_impl="auto",
                          remat=tcfg.grad_ckpt, remat_mode=tcfg.remat_mode,
                          added_cond=added_cond, control_residuals=control)
    v_pred = cfg.schedule.prediction_type == "v_prediction"
    target = (sched_mod.velocity_target(sched, latents, noise, t) if v_pred
              else noise)
    # fp32 MSE, mean over pixels then batch (reference :483)
    per_ex = torch.mean((pred.float() - target) ** 2,
                        dim=tuple(range(1, pred.dim())))
    if tcfg.min_snr_gamma > 0:
        # min(SNR, γ)/SNR for eps, min(SNR, γ)/(SNR + 1) for v
        a = sched.alphas_cumprod[t].float()
        snr = a / torch.clamp(1.0 - a, min=1e-8)
        denom = snr + 1.0 if v_pred else torch.clamp(snr, min=1e-8)
        per_ex = per_ex * torch.clamp(snr, max=tcfg.min_snr_gamma) / denom
    if prior_n:
        # DreamBooth: instance mean + weighted class-prior mean
        return (per_ex[:-prior_n].mean()
                + tcfg.prior_weight * per_ex[-prior_n:].mean())
    return per_ex.mean()


def _xl_conditioning(models, batch, cfg: PipelineConfig, latents, dt):
    """SDXL's (context, added_cond) of a micro-batch: the dual-encoder
    context and the text-time embedding's input.  Training images are
    plain resizes, so the micro-conditioning is the uncropped
    (S, S, 0, 0, S, S), S the image side of the latent grid; the
    refiner's is (S, S, 0, 0, 6.0), the aesthetic score the diffusers
    fine-tuning scripts use."""
    if "input_ids_2" not in batch:
        raise ValueError(
            "SDXL training (cfg.clip2 set) needs batch['input_ids_2'] "
            "from the second tokenizer — build GoodreadsDataset with "
            "tokenizer2 (the finetune CLI does this automatically)")
    ctx, pooled = encode_text_xl(models, batch["input_ids"],
                                 batch["input_ids_2"], cfg, dt)
    s = float(latents.shape[1] * cfg.vae_scale)
    tid = [s, s, 0.0, 0.0] + ([6.0] if cfg.refiner else [s, s])
    time_ids = torch.tensor(tid, dtype=torch.float32,
                            device=latents.device).expand(latents.shape[0],
                                                          len(tid))
    return ctx, xl_added_cond(pooled, time_ids,
                              cfg.unet.addition_time_embed_dim)


def _check_family(cfg: PipelineConfig, tcfg: TrainConfig) -> None:
    """ValueError when ``tcfg``'s family flags disagree with ``cfg``: the
    refiner flag with ``cfg.refiner``, ``dual_text_encoder`` with
    ``cfg.is_sdxl`` (they name which encoders exist and the
    micro-conditioning)."""
    if tcfg.refiner != cfg.refiner:
        raise ValueError(
            f"TrainConfig.refiner={tcfg.refiner} but cfg.refiner="
            f"{cfg.refiner} — set TrainConfig.refiner iff the "
            "PipelineConfig is an SDXL refiner")
    if tcfg.refiner and not tcfg.dual_text_encoder:
        raise ValueError("refiner training implies dual_text_encoder=True "
                         "(the refiner IS an SDXL-family config; its one "
                         "encoder is text_encoder_2)")
    if tcfg.dual_text_encoder != cfg.is_sdxl:
        raise ValueError(
            f"TrainConfig.dual_text_encoder={tcfg.dual_text_encoder} but "
            f"cfg.clip2 is {'set' if cfg.is_sdxl else 'None'} — set "
            "dual_text_encoder iff the PipelineConfig is SDXL")


def make_train_step(cfg: PipelineConfig, tcfg: TrainConfig,
                    compute_dtype=torch.bfloat16, device="cuda",
                    cached_latents: bool = False, mesh=None,
                    dp_size: int = 1):
    """The train step ``step(state, batch, generator=None, draws=None)``.

    ``batch``: {"pixel_values" (grad_accum, micro, H, W, 3) or, with
    ``cached_latents``, "latent_mean"/"latent_logvar" (grad_accum, micro,
    h, w, c), "input_ids" (grad_accum, micro, ctx) (SDXL: and
    "input_ids_2"), and the prior_* keys under prior preservation};
    ``draws``: a list of ``grad_accum`` per-micro-batch dicts (see
    ``diffusion_loss``, ``host_draws``).
    Updates ``state`` in place and returns (state, {"loss", "finite",
    "notfinite_count"}), the last being the cumulative count of skipped
    updates.

    ``mesh`` (``parallel.make_mesh``): the data-parallel step.  ``batch``
    holds this rank's rows of the global micro-batches
    (``make_dataloader(mesh=)``); ``draws`` are the GLOBAL draws, or the
    generator draws the global batch's alike on every rank, and each rank
    keeps its rows.  After the micro-batches' backward passes the
    gradients are averaged over the data group, the loss too, and the
    finite flag and the clipping norm are reduced over every rank: the
    step equals the one-process step on the global batch.  A state cut
    by ``shard_train_state`` runs FSDP (shards gathered at use, gradients
    reduce-scattered) and/or tensor parallelism (each rank computing with
    its slice) through the same step.  ``dp_size``: the data ranks, for
    ``lr_scale_by_dp``."""
    _check_family(cfg, tcfg)
    if tcfg.prior_weight > 0 and cached_latents:
        raise ValueError("prior_weight (prior preservation) is incompatible "
                         "with cached latents — the class set has no latent "
                         "cache; drop --cache_latents")
    device = torch.device(device)
    sched = sched_mod.make_schedule(cfg.schedule, device=device)
    opt = make_optimizer(tcfg, dp_size, mesh=mesh)

    def step_fn(state: TrainState, batch, generator=None, draws=None):
        leaves = optimizer_leaves(state.trainable)
        params = _flat(leaves)
        for p in params:
            p.grad = None
        lsum = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(tcfg.grad_accum):
            mb = {k: v[i].to(device) for k, v in batch.items()}
            d = None if draws is None else draws[i]
            if mesh is not None:
                d = _local_draws(d, generator, mb, cfg, tcfg, mesh)
            # the merge is redone per micro-batch: its graph goes with
            # each backward
            with merged(state.trainable, state.frozen, tcfg) as models:
                loss = diffusion_loss(
                    models, mb, cfg, tcfg, sched, compute_dtype,
                    generator=generator, draws=d)
                loss.backward()  # .grad sums the micro-batches' gradients
            lsum = lsum + loss.detach()
        with torch.no_grad():
            grads = [[torch.zeros_like(p) if p.grad is None
                      else p.grad.div_(tcfg.grad_accum) for p in leaf]
                     for leaf in leaves]
            if mesh is not None:
                from sdbc_tpu_torch.parallel import comm

                _mean_over_data(_flat(grads), params, mesh)
                lsum = lsum.reshape(1)
                comm.all_reduce_mean_([lsum], mesh.get_group("data"))
                lsum = lsum.reshape(())
            state.opt_state = opt.update(grads, state.opt_state, leaves)
            for p in params:
                p.grad = None
            if tcfg.ema_decay > 0:
                t = float(state.step + 1)
                d = min(tcfg.ema_decay, (1.0 + t) / (10.0 + t))
                for e, p in _ema_pairs(state):
                    e.copy_(e * d + p * (1.0 - d))
        state.step += 1
        return state, {"loss": float(lsum / tcfg.grad_accum),
                       "finite": state.opt_state.last_finite,
                       "notfinite_count": state.opt_state.total_notfinite}

    return step_fn
