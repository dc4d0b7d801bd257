"""Every function of the port's ``diffusion/schedulers.py`` against
``sdbc_tpu.diffusion.schedulers`` on the same seeded numpy inputs, with no
UNet: schedules and grids exactly (float grids to 1e-6 relative), single
steps within 1e-5, and the multistep chains (PNDM, LMS, DPM-Solver++ and
its SDE variant, UniPC) over six steps from one fixed eps sequence."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.diffusion import schedulers as js
from sdbc_tpu_torch.diffusion import schedulers as ts
from tests.torch_threads import one_thread  # noqa: F401

ATOL = 1e-5
SHAPE = (2, 4, 4, 4)

CONFIGS = {
    "sd15": {},
    "linear": dict(beta_schedule="linear"),
    "zero_snr-v-trailing": dict(rescale_zero_snr=True,
                                prediction_type="v_prediction",
                                timestep_spacing="trailing"),
}


def cfgs(name):
    kw = CONFIGS[name]
    return js.ScheduleConfig(**kw), ts.ScheduleConfig(**kw)


def scheds(name):
    jc, tc = cfgs(name)
    return jc, tc, js.make_schedule(jc), ts.make_schedule(tc)


def arrays(seed, n=1, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def close(out, ref, atol=ATOL):
    """Within ``atol`` of the JAX result, scaled by its largest magnitude
    where that exceeds 1 (fp32 steps carry ulp-level drift: the two
    packages' ā tables differ in the last bits)."""
    out = out.float().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, atol=atol * scale, rtol=0)


T = torch.from_numpy
J = jnp.asarray


def S(x):
    """A host σ as the 0-d fp32 tensor the σ-space steps take."""
    return torch.tensor(np.float32(x))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_schedule_matches_jax(name):
    _, _, jsch, tsch = scheds(name)
    # fp32 linspace and a 1000-term cumulative product: ulp-level drift,
    # which the zero-SNR rescale (s − s_T near T) and its betas
    # (1 − ā_t/ā_{t−1}) cancel down to absolute terms
    zero_snr = bool(CONFIGS[name].get("rescale_zero_snr"))
    for field in ("alphas_cumprod", "final_alpha_cumprod"):
        np.testing.assert_allclose(getattr(tsch, field).numpy(),
                                   np.asarray(getattr(jsch, field)),
                                   rtol=1e-5, atol=1e-5 if zero_snr else 1e-7)
    close(tsch.betas, jsch.betas, 1e-5 if zero_snr else 1e-6)
    if CONFIGS[name].get("rescale_zero_snr"):
        assert tsch.alphas_cumprod[-1].item() == 0.0


def test_zero_snr_refuses_epsilon():
    with pytest.raises(ValueError, match="rescale_zero_snr"):
        ts.make_schedule(ts.ScheduleConfig(rescale_zero_snr=True))


@pytest.mark.parametrize("name", ["sd15", "zero_snr-v-trailing"])
@pytest.mark.parametrize("steps", [1, 4, 25, 50, 1000])
def test_integer_grids_match_jax(name, steps):
    jc, tc = cfgs(name)
    assert ts.inference_stride(tc, steps) == js.inference_stride(jc, steps)
    np.testing.assert_array_equal(ts.ddim_timesteps(tc, steps).numpy(),
                                  np.asarray(js.ddim_timesteps(jc, steps)))
    for fn in ("lms_timesteps", "dpm_timesteps", "unipc_timesteps"):
        np.testing.assert_array_equal(getattr(ts, fn)(tc, steps).numpy(),
                                      np.asarray(getattr(js, fn)(jc, steps)))
    np.testing.assert_array_equal(ts._host_grid(tc, steps),
                                  js._host_grid(jc, steps))
    if name == "sd15":
        np.testing.assert_array_equal(
            ts.pndm_timesteps(tc, steps).numpy(),
            np.asarray(js.pndm_timesteps(jc, steps)))
    if steps <= 50:
        np.testing.assert_array_equal(ts.lcm_timesteps(tc, steps).numpy(),
                                      np.asarray(js.lcm_timesteps(jc, steps)))


def test_grid_refusals_match_jax():
    jc, tc = cfgs("sd15")
    for fn, args in (("inference_stride", (0,)), ("inference_stride", (1001,)),
                     ("lcm_timesteps", (51,)), ("ddim_timesteps", (0,))):
        with pytest.raises(ValueError):
            getattr(js, fn)(jc, *args)
        with pytest.raises(ValueError):
            getattr(ts, fn)(tc, *args)
    bad = dataclasses.replace(tc, timestep_spacing="linspace")
    with pytest.raises(ValueError, match="timestep_spacing"):
        ts.ddim_timesteps(bad, 10)


@pytest.mark.parametrize("name", ["sd15", "linear"])
@pytest.mark.parametrize("steps", [1, 3, 10, 25])
def test_sigma_grids_and_lms_tables_match_jax(name, steps):
    jc, tc = cfgs(name)
    for fn in ("karras_grid", "leading_sigma_grid"):
        (js_sig, js_t), (t_sig, t_t) = getattr(js, fn)(jc, steps), \
            getattr(ts, fn)(tc, steps)
        assert t_sig.dtype == t_t.dtype == np.float32
        np.testing.assert_allclose(t_sig, js_sig, rtol=1e-6, atol=0)
        np.testing.assert_allclose(t_t, js_t, rtol=1e-6, atol=0)
    np.testing.assert_allclose(ts.lms_coeff_table(tc, steps),
                               np.asarray(js.lms_coeff_table(jc, steps)),
                               rtol=1e-6, atol=1e-7)
    sig = js.karras_grid(jc, steps)[0]
    np.testing.assert_allclose(ts.lms_coeff_table_sigmas(sig),
                               np.asarray(js.lms_coeff_table_sigmas(sig)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_single_steps_match_jax(name):
    jc, tc, jsch, tsch = scheds(name)
    x, out, noise, x0 = arrays(1, 4)
    pt = jc.prediction_type
    t_first = int(ts._host_grid(tc, 10)[0])
    for t, t_prev in ((t_first, t_first - 100), (19, -1), (500, 499)):
        close(ts.ddim_step(tsch, T(out), t, t_prev, T(x), prediction_type=pt),
              js.ddim_step(jsch, J(out), t, t_prev, J(x), prediction_type=pt))
        close(ts.ddim_step(tsch, T(out), t, t_prev, T(x), eta=0.7,
                           prediction_type=pt, noise=T(noise)),
              js.ddim_step(jsch, J(out), t, t_prev, J(x), eta=0.7,
                           prediction_type=pt, noise=J(noise)))
        for p in ("epsilon", "v_prediction"):
            if name == "zero_snr-v-trailing" and p == "epsilon" \
                    and t == t_first:
                continue  # ā = 0 at the trailing grid's first point
            for a, b in zip(ts.to_eps_x0(tsch, T(out), t, T(x), p),
                            js.to_eps_x0(jsch, J(out), t, J(x), p)):
                close(a, b)
        if name == "zero_snr-v-trailing":
            continue  # the eps-parameterised steps divide by α_T = 0
        # ddpm_step draws its noise inside from the key: hand the same over
        key = jax.random.key(t)
        z = np.asarray(jax.random.normal(key, SHAPE, jnp.float32))
        for clip in (False, True):
            close(ts.ddpm_step(tsch, T(out), t, T(x), T(z), clip_sample=clip,
                               t_prev=t_prev),
                  js.ddpm_step(jsch, J(out), t, J(x), key, clip_sample=clip,
                               t_prev=t_prev))
        for anc in (False, True):
            close(ts.euler_step(tsch, T(out), t, t_prev, T(x), T(noise), anc),
                  js.euler_step(jsch, J(out), t, t_prev, J(x), J(noise), anc))
        last = t_prev < 0
        close(ts.lcm_step(tsch, T(x0), t, t_prev, T(x), T(noise), last),
              js.lcm_step(jsch, J(x0), t, t_prev, J(x), J(noise), last))
    tb = np.array([0, 999], np.int64)
    close(ts.ddpm_add_noise(tsch, T(x), T(noise), T(tb)),
          js.ddpm_add_noise(jsch, J(x), J(noise), J(tb)))
    close(ts.velocity_target(tsch, T(x), T(noise), T(tb)),
          js.velocity_target(jsch, J(x), J(noise), J(tb)))
    with pytest.raises(ValueError):
        ts.ddim_step(tsch, T(out), 500, 400, T(x), eta=0.5)


@pytest.mark.parametrize("t", [0, 1, 259.5, 999])
def test_lcm_scalings_and_sigma_helpers_match_jax(t):
    for a, b in zip(ts.lcm_boundary_scalings(t), js.lcm_boundary_scalings(t)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    ab = np.float32(0.3)
    close(ts._ve_sigma(torch.tensor(ab)), js._ve_sigma(J(ab)))
    close(ts._alpha_bar_of_sigma(torch.tensor(np.float32(t / 100))),
          js._alpha_bar_of_sigma(J(np.float32(t / 100))))


@pytest.mark.parametrize("s_t,s_p", [(14.6, 9.1), (2.5, 0.0), (0.3, 0.03)])
def test_sigma_steps_match_jax(s_t, s_p):
    x, e1, e2, noise = arrays(2, 4)
    st, sp = S(s_t), S(s_p)
    jt, jp = np.float32(s_t), np.float32(s_p)
    for anc in (False, True):
        close(ts.euler_step_sigma(T(e1), st, sp, T(x), T(noise), anc),
              js.euler_step_sigma(J(e1), jt, jp, J(x), J(noise), anc))
    close(ts.heun_step_sigma(T(e1), T(e2), st, sp, T(x)),
          js.heun_step_sigma(J(e1), J(e2), jt, jp, J(x)))
    for p in ("epsilon", "v_prediction"):
        for a, b in zip(ts.sigma_to_eps_x0(T(e1), st, T(x), p),
                        js.sigma_to_eps_x0(J(e1), J(jt), J(x), p)):
            close(a, b)


# ---------------------------------------------------------------------------
# multistep chains: six steps from one eps sequence, latents and state


def _eps_seq(n):
    return arrays(3, n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pndm_chain_matches_jax(dtype):
    jc, tc, jsch, tsch = scheds("sd15")
    n = 5
    grid = ts.pndm_timesteps(tc, n).tolist()
    x0, = arrays(4)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, tx = J(x0).astype(jdt), T(x0).to(tdt)
    jst, tst = js.pndm_init_state(SHAPE, jdt), ts.pndm_init_state(SHAPE, tdt)
    for t, eps in zip(grid, _eps_seq(len(grid))):
        jst, jx = js.pndm_step(jsch, jc, jst, J(eps), t, jx, n)
        tst, tx = ts.pndm_step(tsch, tc, tst, T(eps), t, tx, n)
        assert tx.dtype == tdt and tst.cur_sample.dtype == tdt
        tol = ATOL if dtype == "float32" else 2e-2
        close(tx.float(), jx.astype(jnp.float32), tol)
        close(tst.ets, jst.ets, tol)
    assert tst.count == int(jst.count) == n + 1


@pytest.mark.parametrize("karras", [False, True])
def test_lms_chain_matches_jax(karras):
    jc, tc, jsch, tsch = scheds("sd15")
    n = 6
    x0, = arrays(5)
    jx, tx = J(x0), T(x0)
    jst, tst = js.lms_init_state(SHAPE), ts.lms_init_state(SHAPE)
    grid = ts._host_grid(tc, n).tolist()
    if karras:
        sig = js.karras_grid(jc, n)[0]
        table = ts.lms_coeff_table_sigmas(sig)
    else:
        table = ts.lms_coeff_table(tc, n)
    coeffs = T(table)
    for i, eps in enumerate(_eps_seq(n)):
        if karras:
            jst, jx = js.lms_step_sigma(jst, J(eps), sig[i], sig[i + 1], jx,
                                        J(table[i]))
            tst, tx = ts.lms_step_sigma(tst, T(eps), S(sig[i]),
                                        S(sig[i + 1]), tx, coeffs[i])
        else:
            t = grid[i]
            t_prev = grid[i + 1] if i + 1 < n else -1
            jst, jx = js.lms_step(jsch, jst, J(eps), t, t_prev, jx,
                                  J(table[i]))
            tst, tx = ts.lms_step(tsch, tst, T(eps), t, t_prev, tx,
                                  coeffs[i])
        close(tx, jx)
        close(tst.ders, jst.ders)
    assert tst.count == int(jst.count) == n


@pytest.mark.parametrize("sde", [False, True])
@pytest.mark.parametrize("karras", [False, True])
def test_dpm_chain_matches_jax(sde, karras):
    jc, tc, jsch, tsch = scheds("sd15")
    n = 6
    x0, = arrays(6)
    jx, tx = J(x0), T(x0)
    jst, tst = js.dpm_init_state(SHAPE), ts.dpm_init_state(SHAPE)
    grid = ts._host_grid(tc, n).tolist()
    sig = js.karras_grid(jc, n)[0]
    noises = arrays(7, n)
    for i, eps in enumerate(_eps_seq(n)):
        first = i == n - 1
        z = noises[i]
        if karras:
            a = (sig[i], sig[i + 1])
            b = (S(sig[i]), S(sig[i + 1]))
            if sde:
                jst, jx = js.dpm_sde_step_sigma(jst, J(eps), *a, jx, J(z),
                                                first)
                tst, tx = ts.dpm_sde_step_sigma(tst, T(eps), *b, tx, T(z),
                                                first)
            else:
                jst, jx = js.dpm_step_sigma(jst, J(eps), *a, jx, first)
                tst, tx = ts.dpm_step_sigma(tst, T(eps), *b, tx, first)
        else:
            t = grid[i]
            t_prev = t - js.inference_stride(jc, n)
            if sde:
                jst, jx = js.dpm_sde_step(jsch, jc, jst, J(eps), t, t_prev,
                                          jx, J(z), first)
                tst, tx = ts.dpm_sde_step(tsch, tc, tst, T(eps), t, t_prev,
                                          tx, T(z), first)
            else:
                jst, jx = js.dpm_step(jsch, jc, jst, J(eps), t, t_prev, jx,
                                      first)
                tst, tx = ts.dpm_step(tsch, tc, tst, T(eps), t, t_prev, tx,
                                      first)
        close(tx, jx)
        close(tst.prev_x0, jst.prev_x0, 1e-4)
        close(tst.prev_lambda, jst.prev_lambda)
    assert tst.count == int(jst.count) == n


@pytest.mark.parametrize("name", ["sd15", "zero_snr-v-trailing"])
def test_unipc_chain_matches_jax(name):
    jc, tc, jsch, tsch = scheds(name)
    n = 6
    x, = arrays(8)
    jx, tx = J(x), T(x)
    jst, tst = js.unipc_init_state(SHAPE), ts.unipc_init_state(SHAPE)
    grid = ts._host_grid(tc, n).tolist()
    ratio = ts.inference_stride(tc, n)
    for i, out in enumerate(_eps_seq(n)):
        t = grid[i]
        pt = jc.prediction_type
        _, jx0 = js.to_eps_x0(jsch, J(out), t, jx, pt)
        _, tx0 = ts.to_eps_x0(tsch, T(out), t, tx, pt)
        last = i == n - 1
        jst, jx = js.unipc_step(jsch, jst, jx0, t, t - ratio, jx, last)
        tst, tx = ts.unipc_step(tsch, tst, tx0, t, t - ratio, tx, last)
        close(tx, jx)
        for f in ("m0", "m1", "last_sample", "lam0", "lam1"):
            close(getattr(tst, f), getattr(jst, f))
    assert tst.count == int(jst.count) == n
