"""The SD-1.x fine-tuning step (counterpart of ``sdbc_tpu/train/trainer.py``),
full fine-tune branch, on one device.

  - one step = a Python loop over the micro-batches of a
    (grad_accum, micro, ...) batch: VAE encode (no gradient; image by image
    at 512²-class sizes with a batch > 1), posterior sample ×
    scaling_factor in fp32, noise (+ offset noise) and a uniform timestep,
    DDPM add_noise, CLIP encode, UNet eps-prediction, fp32 per-example MSE
    with optional min-SNR weighting; gradients summed in fp32, divided by
    grad_accum, then ONE optimizer update;
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
the JAX tree has them (``optimizer_leaves``: the text encoder's layers
stacked).  ``grad_ckpt`` checkpoints the UNet (``unet.apply``'s ``remat``,
granularity ``remat_mode``: "block" or "selective"), as the reference's
gradient checkpointing does.  PyTorch
updates in place: the state's modules and moments are changed by ``step``,
and ``init_train_state`` takes ownership of the modules it is given.

Randomness comes from an explicit ``torch.Generator`` or from injected
``draws`` (per micro-batch ``eps``, ``noise``, ``t`` and, with noise
offset, ``offset``): the JAX package's ``jax.random`` streams cannot be
reproduced here, so the parity tests hand the JAX draws over.

Not ported yet (``TrainConfig`` raises ``NotImplementedError``): LoRA,
textual inversion, prior preservation, ControlNet and SDXL training;
v-prediction waits for the SD-2 family.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from sdbc_tpu_torch.diffusion import schedulers as sched_mod
from sdbc_tpu_torch.diffusion.graph import PipelineConfig
from sdbc_tpu_torch.models import clip as clip_mod
from sdbc_tpu_torch.models import unet as unet_mod
from sdbc_tpu_torch.models import vae as vae_mod
from sdbc_tpu_torch.train.adam8bit import AdamW8bit, leaf_parts
from sdbc_tpu_torch.utils.dtypes import cast_floating

_UNPORTED = {"lora_rank": 0, "ti_token": "", "prior_weight": 0.0,
             "train_controlnet": False, "dual_text_encoder": False,
             "refiner": False}


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
    # not ported yet: any value but the default raises
    lora_rank: int = 0
    ti_token: str = ""
    prior_weight: float = 0.0
    train_controlnet: bool = False
    dual_text_encoder: bool = False
    refiner: bool = False

    def __post_init__(self):
        for name, default in _UNPORTED.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"TrainConfig.{name}={getattr(self, name)!r} is not "
                    "ported to sdbc_tpu_torch yet")
        if self.remat_mode not in ("block", "selective"):
            raise ValueError(f"unknown remat_mode {self.remat_mode!r}")

    def trainable_keys(self):
        keys = []
        if self.train_unet:
            keys.append("unet")
        if self.train_text_encoder:
            keys.append("text_encoder")
        return tuple(keys)


@dataclasses.dataclass
class TrainState:
    trainable: Dict[str, torch.nn.Module]   # fp32 masters being optimised
    frozen: Dict[str, torch.nn.Module]      # compute-dtype frozen components
    opt_state: Any
    step: int = 0
    ema: Optional[Dict[str, torch.nn.Module]] = None  # shadow of trainable


def trainable_params(trainable: Dict[str, torch.nn.Module]) -> List[torch.Tensor]:
    """Every parameter of the trainable components, in a fixed order
    (components by name, then module order)."""
    return [p for k in sorted(trainable) for p in trainable[k].parameters()]


def optimizer_leaves(trainable: Dict[str, torch.nn.Module]) -> List[List[torch.Tensor]]:
    """The optimizer's leaves as the JAX package's parameter tree has them,
    each a list of parameters: one parameter, or, for the text encoder's
    ``layers.<i>.<name>``, that name in every layer, in layer order (the
    JAX tree stacks the layers into one array per name)."""
    leaves = []
    for k in sorted(trainable):
        module = trainable[k]
        stacks = {}
        for name, p in module.named_parameters():
            if isinstance(module, clip_mod.CLIPTextModel) \
                    and name.startswith("layers."):
                rest = name.split(".", 2)[2]
                if rest not in stacks:
                    stacks[rest] = []
                    leaves.append(stacks[rest])
                stacks[rest].append(p)
            else:
                leaves.append([p])
    return leaves


def _split_params(models: Dict[str, torch.nn.Module], tcfg: TrainConfig,
                  compute_dtype, device):
    tkeys = tcfg.trainable_keys()
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
        params = _flat(params)
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
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

    def __init__(self, inner, max_grad_norm: float = 0.0):
        self.inner = inner
        self.max_grad_norm = max_grad_norm

    def init(self, params) -> OptState:
        return OptState(inner=self.inner.init(params))

    @torch.no_grad()
    def update(self, grads, state: OptState, params) -> OptState:
        """``grads`` and ``params``: lists of leaves (``optimizer_leaves``)."""
        finite = bool(torch.stack([torch.isfinite(g).all()
                                   for g in _flat(grads)]).all())
        state.last_finite = finite
        if not finite:
            state.notfinite_count += 1
            state.total_notfinite += 1
            return state
        state.notfinite_count = 0
        if self.max_grad_norm > 0:
            norm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                  for g in _flat(grads)))
            if not bool(norm < self.max_grad_norm):
                grads = [[g / norm * self.max_grad_norm
                          for g in leaf_parts(leaf)] for leaf in grads]
        state.inner = self.inner.update(grads, state.inner, params)
        return state


def make_optimizer(tcfg: TrainConfig) -> Optimizer:
    # the reference's opt-in scale_lr: lr × grad_accum × batch size (one
    # device)
    scale = tcfg.grad_accum * tcfg.micro_batch if tcfg.lr_scale_by_dp else 1
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
    return Optimizer(inner, tcfg.max_grad_norm)


# ---------------------------------------------------------------------------
# state


def init_train_state(models: Dict[str, torch.nn.Module], tcfg: TrainConfig,
                     compute_dtype=torch.bfloat16,
                     device="cuda") -> TrainState:
    """``models``: {"text_encoder", "unet", "vae"} modules, moved to
    ``device`` in place (the trainable ones as fp32 masters, the frozen
    ones cast to ``compute_dtype``)."""
    if not tcfg.trainable_keys():
        raise ValueError(
            "nothing to train: set train_unet and/or train_text_encoder")
    trainable, frozen = _split_params(models, tcfg, compute_dtype,
                                      torch.device(device))
    opt = make_optimizer(tcfg)
    ema = None
    if tcfg.ema_decay > 0:
        import copy

        ema = {k: copy.deepcopy(m).requires_grad_(False)
               for k, m in trainable.items()}
    return TrainState(trainable=trainable, frozen=frozen,
                      opt_state=opt.init(optimizer_leaves(trainable)),
                      step=0, ema=ema)


def merged_params(state: TrainState,
                  use_ema: bool = False) -> Dict[str, torch.nn.Module]:
    """{text_encoder, unet, vae} modules for inference or checkpointing;
    ``use_ema`` serves the EMA shadow (raises without one)."""
    trainable = state.trainable
    if use_ema:
        if state.ema is None:
            raise ValueError("use_ema=True on a state with no EMA shadow "
                             "(train with TrainConfig.ema_decay > 0)")
        trainable = state.ema
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


def diffusion_loss(models, batch, cfg: PipelineConfig, tcfg: TrainConfig,
                   sched: sched_mod.Schedule, compute_dtype=torch.bfloat16,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[dict] = None):
    """Single-micro-batch denoising MSE (reference finetune_sd.py:460-483).

    ``draws``: {"eps", "noise", "t"} (+ "offset" with noise offset) for
    this micro-batch; otherwise they come from ``generator``."""
    dt = compute_dtype
    draws = draws or {}
    pixels = batch["pixel_values"].to(dt)            # (B, H, W, 3) in [-1,1]
    dev = pixels.device
    vae = models["vae"]
    with torch.no_grad():
        if vae_mod.prefer_chunked_encode(*pixels.shape[:3]):
            mean, logvar = vae_mod.encode_moments_chunked(vae, pixels)
        else:
            mean, logvar = vae_mod.encode_moments(vae, pixels)
        normal = lambda shape: lambda g: torch.randn(
            shape, generator=g, device=dev, dtype=torch.float32)
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

    ctx = clip_mod.apply(models["text_encoder"], batch["input_ids"],
                         compute_dtype=dt)
    pred = unet_mod.apply(models["unet"], noisy, t, ctx, attn_impl="auto",
                          remat=tcfg.grad_ckpt, remat_mode=tcfg.remat_mode)
    # fp32 MSE, mean over pixels then batch (reference :483)
    per_ex = torch.mean((pred.float() - noise) ** 2,
                        dim=tuple(range(1, pred.dim())))
    if tcfg.min_snr_gamma > 0:
        a = sched.alphas_cumprod[t].float()
        snr = a / torch.clamp(1.0 - a, min=1e-8)
        per_ex = per_ex * torch.clamp(snr, max=tcfg.min_snr_gamma) \
            / torch.clamp(snr, min=1e-8)
    return per_ex.mean()


def make_train_step(cfg: PipelineConfig, tcfg: TrainConfig,
                    compute_dtype=torch.bfloat16, device="cuda"):
    """The train step ``step(state, batch, generator=None, draws=None)``.

    ``batch``: {"pixel_values" (grad_accum, micro, H, W, 3),
    "input_ids" (grad_accum, micro, ctx)}; ``draws``: a list of
    ``grad_accum`` per-micro-batch dicts (see ``diffusion_loss``).  Updates
    ``state`` in place and returns (state, {"loss", "finite",
    "notfinite_count"}), the last being the cumulative count of skipped
    updates."""
    if cfg.schedule.prediction_type != "epsilon":
        raise NotImplementedError("v-prediction training is not ported")
    device = torch.device(device)
    sched = sched_mod.make_schedule(cfg.schedule, device=device)
    opt = make_optimizer(tcfg)

    def step_fn(state: TrainState, batch, generator=None, draws=None):
        models = merged_params(state)
        leaves = optimizer_leaves(state.trainable)
        params = _flat(leaves)
        for p in params:
            p.grad = None
        lsum = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(tcfg.grad_accum):
            mb = {k: v[i].to(device) for k, v in batch.items()}
            loss = diffusion_loss(models, mb, cfg, tcfg, sched, compute_dtype,
                                  generator=generator,
                                  draws=None if draws is None else draws[i])
            loss.backward()  # .grad sums the micro-batches' fp32 gradients
            lsum = lsum + loss.detach()
        with torch.no_grad():
            grads = [[torch.zeros_like(p) if p.grad is None
                      else p.grad.div_(tcfg.grad_accum) for p in leaf]
                     for leaf in leaves]
            state.opt_state = opt.update(grads, state.opt_state, leaves)
            for p in params:
                p.grad = None
            if tcfg.ema_decay > 0:
                t = float(state.step + 1)
                d = min(tcfg.ema_decay, (1.0 + t) / (10.0 + t))
                for k in state.ema:
                    for e, p in zip(state.ema[k].parameters(),
                                    state.trainable[k].parameters()):
                        e.copy_(e * d + p * (1.0 - d))
        state.step += 1
        return state, {"loss": float(lsum / tcfg.grad_accum),
                       "finite": state.opt_state.last_finite,
                       "notfinite_count": state.opt_state.total_notfinite}

    return step_fn
