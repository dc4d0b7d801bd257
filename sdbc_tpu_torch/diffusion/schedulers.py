"""Diffusion schedulers as plain PyTorch functions (counterpart of
``sdbc_tpu/diffusion/schedulers.py``).

SD-1.x schedule: scaled_linear betas (sqrt-space linear) from 0.00085 to
0.012 over 1000 train steps, ``set_alpha_to_one=False``, ``steps_offset=0``.
Every sampler of the JAX package is here: DDIM (with eta), the strided
DDPM posterior, PNDM/PLMS, Euler (ancestral), k-LMS, DPM-Solver++(2M) and
its SDE variant, UniPC (bh2, order 2), LCM, Heun, and the Karras σ grids.
All math is fp32; tables the JAX package builds on the host in float64
numpy (LMS coefficients, σ grids) are built the same way here.

PyTorch runs the sampling loop on the host, so the timestep ``t`` and the
grid position are host numbers: where the JAX package selects with
``jnp.where`` on a traced ``t`` (``t_prev >= 0``, the PNDM warm-up
counter, the multistep order switch), these functions take the same branch
in Python, with the same fp32 casts.  Schedule tables are indexed with
host integers, so no step reads a device value back.  A state's ``count``
is a host integer for the same reason; its tensors stay on the latents'
device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
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
    # "epsilon" (SD-1.x) or "v_prediction" (SD-2.x-style checkpoints)
    prediction_type: str = "epsilon"
    # affine rescale of sqrt(ā) to a terminal ā_T of exactly 0
    # (arXiv:2305.08891); needs v_prediction
    rescale_zero_snr: bool = False
    # "leading" (the reference's grids) or "trailing" (starts at T-1)
    timestep_spacing: str = "leading"

    @staticmethod
    def sd15() -> "ScheduleConfig":
        return ScheduleConfig()


class Schedule(NamedTuple):
    betas: torch.Tensor            # (T,)
    alphas_cumprod: torch.Tensor   # (T,)
    final_alpha_cumprod: torch.Tensor  # scalar: ā_0, or 1 with set_alpha_to_one


def make_schedule(cfg: ScheduleConfig, device="cpu") -> Schedule:
    t = cfg.num_train_timesteps
    if cfg.beta_schedule == "scaled_linear":
        betas = torch.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, t,
                               dtype=torch.float32, device=device) ** 2
    elif cfg.beta_schedule == "linear":
        betas = torch.linspace(cfg.beta_start, cfg.beta_end, t,
                               dtype=torch.float32, device=device)
    else:
        raise ValueError(cfg.beta_schedule)
    alphas_cumprod = torch.cumprod(1.0 - betas, dim=0)
    if cfg.rescale_zero_snr:
        if cfg.prediction_type == "epsilon":
            raise ValueError(
                "rescale_zero_snr makes the terminal alpha_bar exactly 0, "
                "where the epsilon->x0 map is singular — use "
                "prediction_type='v_prediction' (arXiv:2305.08891 trains "
                "with v-prediction for exactly this reason)")
        # affine rescale of sqrt(ā): ā_0 kept, ā_T -> 0
        s = torch.sqrt(alphas_cumprod)
        s0, s_t = s[0], s[-1]
        s = (s - s_t) * (s0 / (s0 - s_t))
        alphas_cumprod = s ** 2
        alphas = torch.cat([alphas_cumprod[:1],
                            alphas_cumprod[1:] / alphas_cumprod[:-1]])
        betas = 1.0 - alphas
    final = (torch.ones((), dtype=torch.float32, device=device)
             if cfg.set_alpha_to_one else alphas_cumprod[0])
    return Schedule(betas, alphas_cumprod, final)


def _a_prev(sched: Schedule, t_prev: int, final=None) -> torch.Tensor:
    """ā at ``t_prev``; below 0 ``final`` (default: 1, the terminal σ = 0)."""
    if t_prev >= 0:
        return sched.alphas_cumprod[t_prev]
    if final is not None:
        return final
    return torch.ones_like(sched.final_alpha_cumprod)


# ---------------------------------------------------------------------------
# DDPM (training: q(x_t | x_0); also the ancestral sampling step)


def ddpm_add_noise(sched: Schedule, x0, noise, timesteps):
    """Forward-process sample x_t = sqrt(ā_t)·x0 + sqrt(1−ā_t)·ε in fp32,
    cast back to x0's dtype (DDPMScheduler.add_noise, the reference's
    finetune_sd.py:473).  timesteps: (B,) ints in [0, T)."""
    a = sched.alphas_cumprod[timesteps].float()
    shape = (-1,) + (1,) * (x0.dim() - 1)
    sqrt_a = torch.sqrt(a).reshape(shape)
    sqrt_1ma = torch.sqrt(1.0 - a).reshape(shape)
    return (sqrt_a * x0.float() + sqrt_1ma * noise.float()).to(x0.dtype)


def ddpm_step(sched: Schedule, eps, t: int, x_t, noise,
              clip_sample: bool = True, t_prev=None):
    """One ancestral DDPM step t → t_prev with the posterior over the
    actual stride (ā_step = ā_t/ā_prev; at stride 1 the textbook DDPM
    eq. 7).  t_prev defaults to t−1; t_prev < 0 is the final step (ā_prev
    = 1, no noise added).  ``noise``: standard normal, x_t-shaped (drawn
    by the caller, used up even on the final step)."""
    if t_prev is None:
        t_prev = t - 1
    a_t = sched.alphas_cumprod[t]
    a_prev = _a_prev(sched, t_prev)
    a_step = a_t / a_prev
    beta_step = 1.0 - a_step
    xf, ef = x_t.float(), eps.float()
    x0 = (xf - torch.sqrt(1.0 - a_t) * ef) / torch.sqrt(a_t)
    if clip_sample:
        x0 = torch.clamp(x0, -1.0, 1.0)
    coef_x0 = torch.sqrt(a_prev) * beta_step / (1.0 - a_t)
    coef_xt = torch.sqrt(a_step) * (1.0 - a_prev) / (1.0 - a_t)
    mean = coef_x0 * x0 + coef_xt * xf
    if t_prev < 0:
        return mean.to(x_t.dtype)
    var = torch.clamp(beta_step * (1.0 - a_prev) / (1.0 - a_t), min=1e-20)
    return (mean + torch.sqrt(var) * noise.float()).to(x_t.dtype)


def to_eps_x0(sched: Schedule, model_out, t: int, x_t,
              prediction_type: str):
    """(eps, x0) of a model output under its parameterisation:
    epsilon (model_out = ε) or v_prediction (model_out = α·ε − σ·x0)."""
    a_t = sched.alphas_cumprod[t]
    alpha = torch.sqrt(a_t)
    sigma = torch.sqrt(1.0 - a_t)
    xf, mo = x_t.float(), model_out.float()
    if prediction_type == "v_prediction":
        return sigma * xf + alpha * mo, alpha * xf - sigma * mo
    if prediction_type == "epsilon":
        return mo, (xf - sigma * mo) / alpha
    raise ValueError(f"unknown prediction_type {prediction_type}")


def velocity_target(sched: Schedule, x0, noise, timesteps):
    """Training target for v-prediction: v = α·ε − σ·x0 (per-example t)."""
    a = sched.alphas_cumprod[timesteps].float()
    shape = (-1,) + (1,) * (x0.dim() - 1)
    alpha = torch.sqrt(a).reshape(shape)
    sigma = torch.sqrt(1.0 - a).reshape(shape)
    return alpha * noise.float() - sigma * x0.float()


# ---------------------------------------------------------------------------
# timestep grids (host integers)


def inference_stride(cfg: ScheduleConfig, num_inference_steps: int) -> int:
    """Train-step stride of a grid of ``num_inference_steps``; refuses more
    steps than train steps (the stride would be 0, every step a no-op)."""
    if not 1 <= num_inference_steps <= cfg.num_train_timesteps:
        raise ValueError(
            f"num_inference_steps must be in [1, {cfg.num_train_timesteps}] "
            f"(got {num_inference_steps})")
    return cfg.num_train_timesteps // num_inference_steps


def _host_grid(cfg: ScheduleConfig, num_inference_steps: int) -> np.ndarray:
    """The descending integer grid as host numpy: "leading"
    [0, r, 2r, ...][::-1] + steps_offset, or "trailing" [T−1, T−1−r, ...]
    (steps_offset does not apply, as in diffusers)."""
    ratio = inference_stride(cfg, num_inference_steps)
    if cfg.timestep_spacing == "trailing":
        return (cfg.num_train_timesteps
                - np.arange(num_inference_steps) * ratio - 1)
    if cfg.timestep_spacing != "leading":
        raise ValueError(f"unknown timestep_spacing "
                         f"{cfg.timestep_spacing!r} (leading|trailing)")
    return (np.arange(num_inference_steps) * ratio + cfg.steps_offset)[::-1]


def ddim_timesteps(cfg: ScheduleConfig, num_inference_steps: int,
                   device="cpu") -> torch.Tensor:
    """The descending integer grid (``_host_grid``) as an int64 tensor."""
    grid = np.ascontiguousarray(_host_grid(cfg, num_inference_steps))
    return torch.from_numpy(grid.astype(np.int64)).to(device)


# ---------------------------------------------------------------------------
# DDIM


def ddim_step(sched: Schedule, model_out, t: int, t_prev: int, x_t,
              eta: float = 0.0, prediction_type: str = "epsilon",
              noise=None):
    """DDIM step t → t_prev; t_prev < 0 selects ``final_alpha_cumprod``.
    eta > 0 adds the diffusers-0.7.2 DDIM variance
    σ_t = η·sqrt((1−ā_prev)/(1−ā_t))·sqrt(1−ā_t/ā_prev) and needs
    ``noise``.  Returns x_t's dtype."""
    a_prev = _a_prev(sched, t_prev, sched.final_alpha_cumprod)
    ef, x0 = to_eps_x0(sched, model_out, t, x_t, prediction_type)
    if eta > 0.0:
        if noise is None:
            raise ValueError("ddim_step with eta > 0 needs `noise`")
        a_t = sched.alphas_cumprod[t]
        var = (1.0 - a_prev) / (1.0 - a_t) * (1.0 - a_t / a_prev)
        sigma = eta * torch.sqrt(var)
        dir_xt = torch.sqrt(1.0 - a_prev - sigma ** 2) * ef
        return (torch.sqrt(a_prev) * x0 + dir_xt
                + sigma * noise.float()).to(x_t.dtype)
    return (torch.sqrt(a_prev) * x0
            + torch.sqrt(1.0 - a_prev) * ef).to(x_t.dtype)


# ---------------------------------------------------------------------------
# PNDM (skip_prk_steps=True → PLMS: linear multistep on the eps history)


class PNDMState(NamedTuple):
    ets: torch.Tensor         # (4, *latent_shape) fp32 eps history, newest first
    count: int                # eps seen so far (host)
    cur_sample: torch.Tensor  # latent held between the first two half-steps


def pndm_timesteps(cfg: ScheduleConfig,
                   num_inference_steps: int) -> torch.Tensor:
    """PLMS grid with skip_prk_steps: [t_N, t_{N−1}, t_{N−1}, ..., t_0] —
    the second step re-runs t_{N−1}; N+1 entries."""
    ratio = inference_stride(cfg, num_inference_steps)
    desc = (np.arange(num_inference_steps) * ratio
            + cfg.steps_offset)[::-1].astype(np.int64)
    return torch.from_numpy(np.concatenate([desc[:1], desc[1:2], desc[1:]]))


def pndm_init_state(latent_shape, dtype=torch.float32,
                    device="cpu") -> PNDMState:
    return PNDMState(
        ets=torch.zeros((4,) + tuple(latent_shape), dtype=torch.float32,
                        device=device),
        count=0,
        cur_sample=torch.zeros(tuple(latent_shape), dtype=dtype,
                               device=device))


def pndm_step(sched: Schedule, cfg: ScheduleConfig, state: PNDMState, eps,
              t: int, x_t, num_inference_steps: int):
    """One PLMS step (diffusers PNDMScheduler.step_plms, skip_prk_steps).
    Returns (new_state, x_prev)."""
    ratio = inference_stride(cfg, num_inference_steps)
    eps = eps.float()
    xf = x_t.float()
    count = state.count
    # the second call steps t + ratio → t from the held cur_sample
    is_second = count == 1
    t_eff, t_prev = (t + ratio, t) if is_second else (t, t - ratio)
    if is_second:
        new_ets = state.ets
    else:
        new_ets = torch.cat([eps[None], state.ets[:-1]])
    e1, e2, e3, e4 = new_ets[0], new_ets[1], new_ets[2], new_ets[3]
    if count == 0:
        eps_prime = eps
    elif count == 1:
        eps_prime = (eps + e1) / 2.0
    elif count == 2:
        eps_prime = (3.0 * e1 - e2) / 2.0
    elif count == 3:
        eps_prime = (23.0 * e1 - 16.0 * e2 + 5.0 * e3) / 12.0
    else:
        eps_prime = (55.0 * e1 - 59.0 * e2 + 37.0 * e3 - 9.0 * e4) / 24.0
    sample = state.cur_sample.float() if is_second else xf
    new_cur = xf if count == 0 else state.cur_sample.float()
    a_t = sched.alphas_cumprod[t_eff]
    a_prev = _a_prev(sched, t_prev, sched.final_alpha_cumprod)
    # diffusers _get_prev_sample closed form
    denom = (a_t * torch.sqrt(1.0 - a_prev)
             + torch.sqrt(a_t * a_prev * (1.0 - a_t)))
    x_prev = (torch.sqrt(a_prev / a_t) * sample
              - (a_prev - a_t) * eps_prime / denom)
    new_state = PNDMState(ets=new_ets, count=count + 1,
                          cur_sample=new_cur.to(x_t.dtype))
    return new_state, x_prev.to(x_t.dtype)


# ---------------------------------------------------------------------------
# Euler (ancestral), in VE coordinates on VP latents: x_ve = x_vp/sqrt(ā),
# σ = sqrt((1−ā)/ā)


def _ve_sigma(alpha_bar):
    return torch.sqrt((1.0 - alpha_bar) / torch.clamp(alpha_bar, min=1e-20))


def _euler_ve(x_ve, ef, s_t, s_p, noise, ancestral: bool, who: str):
    if not ancestral:
        return x_ve + (s_p - s_t) * ef
    if noise is None:
        raise ValueError(f"{who} with ancestral=True needs `noise`")
    var_up = s_p ** 2 * (s_t ** 2 - s_p ** 2) / torch.clamp(s_t ** 2,
                                                            min=1e-20)
    s_up = torch.sqrt(torch.clamp(var_up, min=0.0))
    s_down = torch.sqrt(torch.clamp(s_p ** 2 - var_up, min=0.0))
    return x_ve + (s_down - s_t) * ef + s_up * noise.float()


def euler_step(sched: Schedule, eps, t: int, t_prev: int, x_t, noise=None,
               ancestral: bool = False):
    """One Euler step t → t_prev on VP latents (eps parameterisation);
    t_prev < 0 is σ_prev = 0 (returns the x0 prediction).  ancestral=True
    adds k-diffusion's split σ_down² + σ_up² = σ_prev² and needs
    ``noise``."""
    a_t = sched.alphas_cumprod[t]
    a_prev = _a_prev(sched, t_prev)
    s_t, s_p = _ve_sigma(a_t), _ve_sigma(a_prev)
    x_ve = x_t.float() / torch.sqrt(a_t)
    x_ve = _euler_ve(x_ve, eps.float(), s_t, s_p, noise, ancestral,
                     "euler_step")
    return (x_ve * torch.sqrt(a_prev)).to(x_t.dtype)


# ---------------------------------------------------------------------------
# k-LMS (diffusers-0.7.2 LMSDiscreteScheduler): linear multistep in VE
# σ space; the Lagrange coefficient integrals are polynomials, integrated
# exactly on the host in float64 into an (N, order) table.


class LMSState(NamedTuple):
    ders: torch.Tensor  # (order, *latent_shape) fp32 eps history, newest first
    count: int          # steps taken so far (host)


LMS_ORDER = 4


def lms_timesteps(cfg: ScheduleConfig,
                  num_inference_steps: int) -> torch.Tensor:
    """Same descending grid as DDIM."""
    return ddim_timesteps(cfg, num_inference_steps)


def _train_alphas_cumprod(cfg: ScheduleConfig) -> np.ndarray:
    """(T,) float64 ā of the training schedule (host)."""
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                            cfg.num_train_timesteps, dtype=np.float64) ** 2
    else:
        betas = np.linspace(cfg.beta_start, cfg.beta_end,
                            cfg.num_train_timesteps, dtype=np.float64)
    return np.cumprod(1.0 - betas)


def _lagrange_table(sig: np.ndarray, order: int) -> np.ndarray:
    """(N, order) float64: row i integrates the Lagrange basis over the last
    min(i+1, order) σ points from σ_i to σ_{i+1} (newest first; unused
    slots 0)."""
    n = sig.shape[0] - 1
    table = np.zeros((n, order), np.float64)
    for i in range(n):
        cur = min(i + 1, order)
        for j in range(cur):
            poly = np.poly1d([1.0])
            for k in range(cur):
                if k == j:
                    continue
                poly = poly * np.poly1d([1.0, -sig[i - k]]) \
                    / (sig[i - j] - sig[i - k])
            integ = np.polyint(poly)
            table[i, j] = integ(sig[i + 1]) - integ(sig[i])
    return table


def lms_coeff_table(cfg: ScheduleConfig, num_inference_steps: int,
                    order: int = LMS_ORDER) -> np.ndarray:
    """(N, order) float32 host table of integrated Lagrange coefficients
    over the integer grid's σ (terminal σ 0 appended)."""
    ts = _host_grid(cfg, num_inference_steps)
    ac = _train_alphas_cumprod(cfg)
    sig = np.append(np.sqrt((1.0 - ac[ts]) / ac[ts]), 0.0)
    return _lagrange_table(sig, order).astype(np.float32)


def lms_init_state(latent_shape, order: int = LMS_ORDER,
                   device="cpu") -> LMSState:
    return LMSState(ders=torch.zeros((order,) + tuple(latent_shape),
                                     dtype=torch.float32, device=device),
                    count=0)


def _lms_update(state: LMSState, ef, x_ve, coeff_row):
    ders = torch.cat([ef[None], state.ders[:-1]])
    upd = torch.tensordot(coeff_row.float(), ders, dims=1)
    return LMSState(ders=ders, count=state.count + 1), x_ve + upd


def lms_step(sched: Schedule, state: LMSState, eps, t: int, t_prev: int,
             x_t, coeff_row):
    """One k-LMS step t → t_prev.  ``coeff_row``: the step's row of
    ``lms_coeff_table`` as a tensor on the latents' device.  Returns
    (new_state, x_prev)."""
    a_t = sched.alphas_cumprod[t]
    a_prev = _a_prev(sched, t_prev)
    x_ve = x_t.float() / torch.sqrt(a_t)
    state, x_ve = _lms_update(state, eps.float(), x_ve, coeff_row)
    return state, (x_ve * torch.sqrt(a_prev)).to(x_t.dtype)


# ---------------------------------------------------------------------------
# σ-space family: Karras grids (arXiv:2206.00364 eq. 5) and the steps on an
# explicit (σ_t → σ_prev) pair.  Grids are host numpy; callers move them to
# the latents' device once and pass 0-d slices.


def _train_log_sigmas(cfg: ScheduleConfig) -> np.ndarray:
    """(T,) float64 log σ of the training grid, σ_t = sqrt((1−ā)/ā)."""
    ac = _train_alphas_cumprod(cfg)
    return np.log(np.sqrt((1.0 - ac) / ac))


def karras_grid(cfg: ScheduleConfig, num_inference_steps: int,
                rho: float = 7.0) -> Tuple[np.ndarray, np.ndarray]:
    """Karras σ ramp between the integer grid's endpoint σs → host float32
    (sigmas (N+1,) with a terminal 0, continuous timesteps (N,): each σ's
    fractional position on the training grid, linear in log σ —
    k-diffusion's sigma_to_t)."""
    ts = _host_grid(cfg, num_inference_steps)
    log_sigmas = _train_log_sigmas(cfg)
    sig_grid = np.exp(log_sigmas[ts])
    sigma_max, sigma_min = sig_grid[0], sig_grid[-1]
    if num_inference_steps == 1:
        sigmas = np.asarray([sigma_max], np.float64)
    else:
        ramp = np.linspace(0.0, 1.0, num_inference_steps)
        sigmas = (sigma_max ** (1.0 / rho)
                  + ramp * (sigma_min ** (1.0 / rho)
                            - sigma_max ** (1.0 / rho))) ** rho
    log_s = np.log(sigmas)
    dists = log_s[None, :] - log_sigmas[:, None]          # (T, N)
    low_idx = np.clip(np.cumsum(dists >= 0, axis=0).argmax(axis=0),
                      0, log_sigmas.shape[0] - 2)
    high_idx = low_idx + 1
    low, high = log_sigmas[low_idx], log_sigmas[high_idx]
    w = np.clip((low - log_s) / (low - high), 0.0, 1.0)
    t_cont = (1.0 - w) * low_idx + w * high_idx
    sigmas = np.append(sigmas, 0.0)
    return (np.asarray(sigmas, np.float32), np.asarray(t_cont, np.float32))


def leading_sigma_grid(cfg: ScheduleConfig, num_inference_steps: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(sigmas (N+1,), float timesteps (N,)) of the integer grid with a
    terminal 0 — the non-Karras σ-space grid (host float32)."""
    ts = _host_grid(cfg, num_inference_steps)
    sig = np.exp(_train_log_sigmas(cfg)[ts])
    return (np.asarray(np.append(sig, 0.0), np.float32),
            np.asarray(ts, np.float32))


def _alpha_bar_of_sigma(sigma):
    """VP ā from VE σ: σ² = (1−ā)/ā ⇒ ā = 1/(1+σ²)."""
    return 1.0 / (1.0 + sigma.float() ** 2)


def sigma_to_eps_x0(model_out, sigma, x_t, prediction_type: str):
    """``to_eps_x0`` at a continuous σ (ā = 1/(1+σ²)); ``sigma`` a 0-d
    tensor."""
    a = _alpha_bar_of_sigma(sigma)
    alpha, sig_vp = torch.sqrt(a), torch.sqrt(1.0 - a)
    xf, mo = x_t.float(), model_out.float()
    if prediction_type == "v_prediction":
        return sig_vp * xf + alpha * mo, alpha * xf - sig_vp * mo
    if prediction_type == "epsilon":
        return mo, (xf - sig_vp * mo) / alpha
    raise ValueError(f"unknown prediction_type {prediction_type}")


def euler_step_sigma(eps, s_t, s_p, x_t, noise=None, ancestral: bool = False):
    """``euler_step`` on an explicit (σ_t → σ_prev) pair of 0-d tensors;
    σ_prev = 0 returns the x0 prediction."""
    s_t, s_p = s_t.float(), s_p.float()
    a_t, a_p = _alpha_bar_of_sigma(s_t), _alpha_bar_of_sigma(s_p)
    x_ve = x_t.float() / torch.sqrt(a_t)
    x_ve = _euler_ve(x_ve, eps.float(), s_t, s_p, noise, ancestral,
                     "euler_step_sigma")
    return (x_ve * torch.sqrt(a_p)).to(x_t.dtype)


def heun_step_sigma(eps1, eps2, s_t, s_p, x_t):
    """One Heun (trapezoidal) step σ_t → σ_p in VE space: the slope is the
    mean of the eps at σ_t and at the Euler predictor's end (``eps2``,
    from the caller's second model evaluation)."""
    s_t, s_p = s_t.float(), s_p.float()
    a_t, a_p = _alpha_bar_of_sigma(s_t), _alpha_bar_of_sigma(s_p)
    x_ve = x_t.float() / torch.sqrt(a_t)
    d = 0.5 * (eps1.float() + eps2.float())
    x_ve = x_ve + (s_p - s_t) * d
    return (x_ve * torch.sqrt(a_p)).to(x_t.dtype)


def lms_coeff_table_sigmas(sigmas, order: int = LMS_ORDER) -> np.ndarray:
    """``lms_coeff_table`` over an explicit (N+1,) σ grid (terminal last)."""
    return _lagrange_table(np.asarray(sigmas, np.float64),
                           order).astype(np.float32)


def lms_step_sigma(state: LMSState, eps, s_t, s_p, x_t, coeff_row):
    """``lms_step`` on an explicit (σ_t → σ_prev) pair."""
    a_t, a_p = _alpha_bar_of_sigma(s_t), _alpha_bar_of_sigma(s_p)
    x_ve = x_t.float() / torch.sqrt(a_t)
    state, x_ve = _lms_update(state, eps.float(), x_ve, coeff_row)
    return state, (x_ve * torch.sqrt(a_p)).to(x_t.dtype)


# ---------------------------------------------------------------------------
# DPM-Solver++(2M) (Lu et al. 2022, data prediction, multistep) and its SDE
# variant (midpoint), in log-SNR λ = log(α/σ).


class DPMState(NamedTuple):
    prev_x0: torch.Tensor      # x0 prediction of the previous step
    prev_lambda: torch.Tensor  # () λ at the previous model point
    count: int                 # steps taken so far (host)


def dpm_timesteps(cfg: ScheduleConfig,
                  num_inference_steps: int) -> torch.Tensor:
    """Same descending grid as DDIM."""
    return ddim_timesteps(cfg, num_inference_steps)


def dpm_init_state(latent_shape, device="cpu") -> DPMState:
    return DPMState(prev_x0=torch.zeros(tuple(latent_shape),
                                        dtype=torch.float32, device=device),
                    prev_lambda=torch.zeros((), dtype=torch.float32,
                                            device=device),
                    count=0)


def _lambda_of(alpha_bar):
    """λ = log(α/σ) with α = sqrt(ā), σ = sqrt(1−ā), logs guarded at 1e-20."""
    a = torch.sqrt(alpha_bar)
    s = torch.sqrt(1.0 - alpha_bar)
    return (torch.log(torch.clamp(a, min=1e-20))
            - torch.log(torch.clamp(s, min=1e-20)))


def _lambda_of_sigma(s):
    """λ = −log σ under ā = 1/(1+σ²), guarded at 1e-20 (σ = 0 terminal)."""
    return -torch.log(torch.clamp(s, min=1e-20))


def _dpm_x0_2m(state: DPMState, x0, lam_t, h, first_order: bool):
    """x0 + D1/2 with D1 = (x0 − x0_prev)/r0, r0 = h_prev/h (second order
    from the second step on, unless ``first_order``)."""
    if state.count > 0 and not first_order:
        r0 = (lam_t - state.prev_lambda) / h
        return x0 + 0.5 * ((x0 - state.prev_x0) / r0)
    return x0


def _dpm(state: DPMState, a_t, a_p, lam_t, lam_p, x_t, eps, noise,
         first_order: bool):
    """The shared 2M update (ODE when ``noise`` is None, SDE otherwise)."""
    xf, ef = x_t.float(), eps.float()
    alpha_t, sigma_t = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)
    alpha_p, sigma_p = torch.sqrt(a_p), torch.sqrt(1.0 - a_p)
    x0 = (xf - sigma_t * ef) / alpha_t
    h = lam_p - lam_t
    x0_2m = _dpm_x0_2m(state, x0, lam_t, h, first_order)
    if noise is None:
        x_prev = (sigma_p / sigma_t) * xf - alpha_p * torch.expm1(-h) * x0_2m
    else:
        decay = torch.exp(-h)
        grow = -torch.expm1(-2.0 * h)               # 1 − e^{−2h}
        x_prev = ((sigma_p / sigma_t) * decay * xf
                  + alpha_p * grow * x0_2m
                  + sigma_p * torch.sqrt(torch.clamp(grow, min=0.0))
                  * noise.float())
    new = DPMState(prev_x0=x0, prev_lambda=lam_t, count=state.count + 1)
    return new, x_prev.to(x_t.dtype)


def dpm_step(sched: Schedule, cfg: ScheduleConfig, state: DPMState, eps,
             t: int, t_prev: int, x_t, first_order: bool = False):
    """One DPM-Solver++(2M) step t → t_prev:
    x_prev = (σ_p/σ_t)·x − α_p·expm1(−h)·(x0 + D1/2); the first step (and
    the last when ``first_order``) is first order.  Returns
    (new_state, x_prev)."""
    a_t = sched.alphas_cumprod[t]
    a_p = _a_prev(sched, t_prev, sched.final_alpha_cumprod)
    return _dpm(state, a_t, a_p, _lambda_of(a_t), _lambda_of(a_p), x_t, eps,
                None, first_order)


def dpm_step_sigma(state: DPMState, eps, s_t, s_p, x_t,
                   first_order: bool = False):
    """``dpm_step`` on an explicit (σ_t → σ_prev) pair; σ_prev = 0 returns
    the x0 prediction."""
    s_t, s_p = s_t.float(), s_p.float()
    return _dpm(state, _alpha_bar_of_sigma(s_t), _alpha_bar_of_sigma(s_p),
                _lambda_of_sigma(s_t), _lambda_of_sigma(s_p), x_t, eps, None,
                first_order)


def dpm_sde_step(sched: Schedule, cfg: ScheduleConfig, state: DPMState, eps,
                 t: int, t_prev: int, x_t, noise, first_order: bool = False):
    """One SDE-DPM-Solver++(2M) step (midpoint):
    x_prev = (σ_p/σ_t)·e^{−h}·x + α_p·(1−e^{−2h})·(x0 + D1/2)
             + σ_p·sqrt(1−e^{−2h})·z.  Returns (new_state, x_prev)."""
    a_t = sched.alphas_cumprod[t]
    a_p = _a_prev(sched, t_prev, sched.final_alpha_cumprod)
    return _dpm(state, a_t, a_p, _lambda_of(a_t), _lambda_of(a_p), x_t, eps,
                noise, first_order)


def dpm_sde_step_sigma(state: DPMState, eps, s_t, s_p, x_t, noise,
                       first_order: bool = False):
    """``dpm_sde_step`` on an explicit (σ_t → σ_prev) pair."""
    s_t, s_p = s_t.float(), s_p.float()
    return _dpm(state, _alpha_bar_of_sigma(s_t), _alpha_bar_of_sigma(s_p),
                _lambda_of_sigma(s_t), _lambda_of_sigma(s_p), x_t, eps, noise,
                first_order)


# ---------------------------------------------------------------------------
# UniPC (Zhao et al. 2023, arXiv:2302.04867): bh2 data prediction, order 2


def _alpha_sigma_of_lambda(lam):
    """(α, σ) from λ: α² = sigmoid(2λ)."""
    a2 = torch.sigmoid(2.0 * lam)
    return torch.sqrt(a2), torch.sqrt(1.0 - a2)


class UniPCState(NamedTuple):
    m0: torch.Tensor           # newest x0 prediction (at lam0)
    m1: torch.Tensor           # second newest (at lam1)
    lam0: torch.Tensor         # () λ of m0's model point
    lam1: torch.Tensor         # () λ of m1's model point
    last_sample: torch.Tensor  # corrected sample at lam0
    count: int                 # model evaluations consumed (host)


def unipc_init_state(latent_shape, device="cpu") -> UniPCState:
    z = torch.zeros(tuple(latent_shape), dtype=torch.float32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return UniPCState(m0=z, m1=z, lam0=zero, lam1=zero, last_sample=z,
                      count=0)


def unipc_timesteps(cfg: ScheduleConfig,
                    num_inference_steps: int) -> torch.Tensor:
    """Same descending grid as DDIM."""
    return ddim_timesteps(cfg, num_inference_steps)


def _guard(x, eps: float):
    """x, with entries of magnitude below ``eps`` replaced by 1."""
    return torch.where(torch.abs(x) < eps, torch.ones_like(x), x)


def _unipc_bh2_terms(h):
    """(h_phi_1, B_h, b1, b2) of the B(h) = e^h − 1 variant, hh = −h;
    divisions guarded at h → 0 (the degenerate final step stays an exact
    no-op)."""
    hh = -h
    hh_safe = _guard(hh, 1e-8)
    h_phi_1 = torch.expm1(hh)
    b_h = h_phi_1
    b_safe = _guard(b_h, 1e-12)
    h_phi_2 = h_phi_1 / hh_safe - 1.0
    h_phi_3 = h_phi_2 / hh_safe - 0.5
    return h_phi_1, b_h, h_phi_2 / b_safe, 2.0 * h_phi_3 / b_safe


def unipc_step(sched: Schedule, state: UniPCState, x0_t, t: int, t_prev: int,
               x_t, last_step: bool = False):
    """One UniPC step t → t_prev: the UniC corrector refines x_t with the
    x0 prediction just computed at it (``x0_t``), then the UniP predictor
    advances (order 1 on the first step and, with ``last_step``, the
    last).  Returns (new_state, x_next)."""
    a_t = sched.alphas_cumprod[t]
    a_prev = _a_prev(sched, t_prev, sched.final_alpha_cumprod)
    x0_t = x0_t.float()
    xf = x_t.float()
    lam_t = _lambda_of(a_t)
    alpha_t, sigma_t = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)

    # UniC: a full replacement step from last_sample at lam0
    if state.count == 0:
        x_corr = xf
    else:
        h_c = lam_t - state.lam0
        _, sigma_s0 = _alpha_sigma_of_lambda(state.lam0)
        hp1_c, bh_c, b1_c, b2_c = _unipc_bh2_terms(h_c)
        base_c = ((sigma_t / sigma_s0) * state.last_sample
                  - alpha_t * hp1_c * state.m0)
        d1_t = x0_t - state.m0
        if state.count >= 2:
            r1 = (state.lam1 - state.lam0) / _guard(h_c, 1e-12)
            d1_0 = (state.m1 - state.m0) / _guard(r1, 1e-12)
            rho1 = (b2_c - b1_c) / _guard(r1 - 1.0, 1e-12)
            rho2 = b1_c - rho1
            x_corr = base_c - alpha_t * bh_c * (rho1 * d1_0 + rho2 * d1_t)
        else:
            x_corr = base_c - alpha_t * bh_c * (0.5 * d1_t)

    m0, m1 = x0_t, state.m0
    lam0, lam1 = lam_t, state.lam0

    # UniP: advance the corrected sample to t_prev
    lam_p = _lambda_of(a_prev)
    alpha_p, sigma_p = torch.sqrt(a_prev), torch.sqrt(1.0 - a_prev)
    h_p = lam_p - lam_t
    hp1_p, bh_p, _, _ = _unipc_bh2_terms(h_p)
    base_p = (sigma_p / sigma_t) * x_corr - alpha_p * hp1_p * m0
    if state.count >= 1 and not last_step:
        r1p = (lam1 - lam0) / _guard(h_p, 1e-12)
        d1p = (m1 - m0) / _guard(r1p, 1e-12)
        x_next = base_p - alpha_p * bh_p * (0.5 * d1p)
    else:
        x_next = base_p
    new_state = UniPCState(m0=m0, m1=m1, lam0=lam0, lam1=lam1,
                           last_sample=x_corr, count=state.count + 1)
    return new_state, x_next.to(x_t.dtype)


# ---------------------------------------------------------------------------
# LCM — Latent Consistency Models (Luo et al. 2023, arXiv:2310.04378)


def lcm_timesteps(cfg: ScheduleConfig, num_inference_steps: int,
                  original_inference_steps: int = 50) -> torch.Tensor:
    """The LCM grid: ``num_inference_steps`` picked evenly, highest noise
    first, from the ``original_inference_steps`` distillation grid (999,
    759, 519, 279 at 4 steps for the SD grid)."""
    if not 0 < num_inference_steps <= original_inference_steps:
        raise ValueError(
            f"LCM num_inference_steps must be in [1, "
            f"{original_inference_steps}] (the distillation grid size), "
            f"got {num_inference_steps}")
    if cfg.num_train_timesteps % original_inference_steps:
        raise ValueError(
            f"original_inference_steps ({original_inference_steps}) must "
            f"divide num_train_timesteps ({cfg.num_train_timesteps})")
    k = cfg.num_train_timesteps // original_inference_steps
    origin = np.arange(1, original_inference_steps + 1) * k - 1
    skip = original_inference_steps // num_inference_steps
    ts = origin[::-1][::skip][:num_inference_steps]
    return torch.from_numpy(np.ascontiguousarray(ts).astype(np.int64))


def lcm_boundary_scalings(t: float, timestep_scaling: float = 10.0,
                          sigma_data: float = 0.5):
    """(c_skip, c_out) at timestep t as fp32 0-d tensors:
    c_skip = σ_d²/(s²+σ_d²), c_out = s/sqrt(s²+σ_d²), s = t·scaling."""
    s = torch.tensor(float(t), dtype=torch.float32) * timestep_scaling
    c_skip = sigma_data ** 2 / (s ** 2 + sigma_data ** 2)
    c_out = s / torch.sqrt(s ** 2 + sigma_data ** 2)
    return c_skip, c_out


def lcm_step(sched: Schedule, x0_t, t: int, t_next: int, x_t, noise,
             last_step: bool = False):
    """One LCM step t → t_next: the consistency output
    c_skip·x_t + c_out·x0, re-noised to t_next with ``noise`` except on
    the last step."""
    xf = x_t.float()
    c_skip, c_out = lcm_boundary_scalings(t)
    # host fp32 scalars: the same rounding as the JAX package's, no copy
    denoised = float(c_skip) * xf + float(c_out) * x0_t.float()
    if last_step:
        return denoised.to(x_t.dtype)
    a_next = sched.alphas_cumprod[max(t_next, 0)]
    noised = (torch.sqrt(a_next) * denoised
              + torch.sqrt(1.0 - a_next) * noise.float())
    return noised.to(x_t.dtype)
