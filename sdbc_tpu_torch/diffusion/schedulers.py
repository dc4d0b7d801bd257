"""DDIM scheduler and the DDPM forward process (counterpart of those parts
of ``sdbc_tpu/diffusion/schedulers.py``).

SD-1.x schedule: scaled_linear betas (sqrt-space linear) from 0.00085 to
0.012 over 1000 train steps, ``set_alpha_to_one=False``, ``steps_offset=0``,
leading timestep spacing, eta = 0, epsilon prediction.  All math is fp32.
The other samplers and options wait for a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    clip_sample: bool = False
    set_alpha_to_one: bool = False
    steps_offset: int = 0
    prediction_type: str = "epsilon"
    timestep_spacing: str = "leading"

    @staticmethod
    def sd15() -> "ScheduleConfig":
        return ScheduleConfig()


class Schedule(NamedTuple):
    betas: torch.Tensor            # (T,)
    alphas_cumprod: torch.Tensor   # (T,)
    final_alpha_cumprod: torch.Tensor  # scalar: ā_0 (set_alpha_to_one=False)


def make_schedule(cfg: ScheduleConfig, device="cpu") -> Schedule:
    if (cfg.beta_schedule != "scaled_linear" or cfg.set_alpha_to_one
            or cfg.clip_sample or cfg.prediction_type != "epsilon"
            or cfg.timestep_spacing != "leading"):
        raise NotImplementedError(f"schedule {cfg} is not ported")
    betas = torch.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                           cfg.num_train_timesteps, dtype=torch.float32,
                           device=device) ** 2
    alphas_cumprod = torch.cumprod(1.0 - betas, dim=0)
    return Schedule(betas, alphas_cumprod, alphas_cumprod[0])


def inference_stride(cfg: ScheduleConfig, num_inference_steps: int) -> int:
    if not 1 <= num_inference_steps <= cfg.num_train_timesteps:
        raise ValueError(
            f"num_inference_steps must be in [1, {cfg.num_train_timesteps}] "
            f"(got {num_inference_steps})")
    return cfg.num_train_timesteps // num_inference_steps


def ddim_timesteps(cfg: ScheduleConfig, num_inference_steps: int,
                   device="cpu") -> torch.Tensor:
    """Descending leading grid [0, r, 2r, ...][::-1] + steps_offset."""
    ratio = inference_stride(cfg, num_inference_steps)
    ts = torch.arange(num_inference_steps, device=device) * ratio
    return (ts + cfg.steps_offset).flip(0).to(torch.int64)


def ddim_step(sched: Schedule, model_out, t: int, t_prev: int, x_t):
    """Deterministic (eta = 0) DDIM step t → t_prev on an epsilon prediction;
    t_prev < 0 selects ā_0 (set_alpha_to_one=False).  Returns x_t's dtype."""
    a_t = sched.alphas_cumprod[t]
    a_prev = (sched.alphas_cumprod[t_prev] if t_prev >= 0
              else sched.final_alpha_cumprod)
    xf, eps = x_t.float(), model_out.float()
    x0 = (xf - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    return (torch.sqrt(a_prev) * x0
            + torch.sqrt(1.0 - a_prev) * eps).to(x_t.dtype)


def ddpm_add_noise(sched: Schedule, x0, noise, timesteps):
    """Forward-process sample x_t = sqrt(ā_t)·x0 + sqrt(1−ā_t)·ε in fp32,
    cast back to x0's dtype (DDPMScheduler.add_noise, the reference's
    finetune_sd.py:473).  timesteps: (B,) ints in [0, T)."""
    a = sched.alphas_cumprod[timesteps].float()
    shape = (-1,) + (1,) * (x0.dim() - 1)
    sqrt_a = torch.sqrt(a).reshape(shape)
    sqrt_1ma = torch.sqrt(1.0 - a).reshape(shape)
    return (sqrt_a * x0.float() + sqrt_1ma * noise.float()).to(x0.dtype)
