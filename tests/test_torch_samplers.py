"""Port parity: the other samplers against the JAX package on the CPU in
f32 — ``make_ddim_params_traced``, ``spatial_norm_thresholding``, the
Gaussian posterior utilities, ``ddim_sample`` / ``ddim_encode``, the
standalone ``dpmpp_2m_decode``, ``plms_decode`` and the DDPM ancestral
sampler — on a toy eps-model and on the small UNet, with the JAX
programs' noises rebuilt along their key splits.

Gates: latent relative error <= 1e-4 (decoded PSNR >= 80 dB on the
UNet), equality for the traced DDIM timesteps and the DDPM loop's
intermediate indices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu.diffusion import ddim as JD
from sd_animation_optical_flow_tpu.diffusion import ddpm_sampler as JP
from sd_animation_optical_flow_tpu.diffusion import distributions as JDI
from sd_animation_optical_flow_tpu.diffusion import dpm_solver as JDPM
from sd_animation_optical_flow_tpu.diffusion import plms as JPL
from sd_animation_optical_flow_tpu.diffusion import sampling_util as JSU
from sd_animation_optical_flow_tpu.diffusion import schedule as JS
from sd_animation_optical_flow_tpu.models import unet as JU
from sd_animation_optical_flow_tpu_torch.diffusion import ddim as TD
from sd_animation_optical_flow_tpu_torch.diffusion import ddpm_sampler as TP
from sd_animation_optical_flow_tpu_torch.diffusion import distributions as TDI
from sd_animation_optical_flow_tpu_torch.diffusion import dpm_solver as TDPM
from sd_animation_optical_flow_tpu_torch.diffusion import multistep as TM
from sd_animation_optical_flow_tpu_torch.diffusion import plms as TPL
from sd_animation_optical_flow_tpu_torch.diffusion import sampling_util as TSU
from sd_animation_optical_flow_tpu_torch.diffusion import schedule as TS
from sd_animation_optical_flow_tpu_torch.models import unet as TU
from sd_animation_optical_flow_tpu_torch.models import vae as TV
from torch_port_common import (jax_models, np_t, rel_err, to_port,
                               torch_configs)

JSCHED, TSCHED = JS.make_linear_schedule(), TS.make_linear_schedule()
SHAPE = (2, 4, 5, 4)


def _toy(lib):
    """A deterministic eps-model of x, t, the context and any concat
    channels (past the 4 latent ones), in JAX (lib jnp) or torch."""
    def model_fn(x, t, ctx, control=None):
        if lib is jnp:
            tt = (t.astype(x.dtype) / 1000.0).reshape(-1, 1, 1, 1)
            cm = ctx.mean(axis=(1, 2)).reshape(-1, 1, 1, 1)
            extra = x[..., 4:].mean(axis=-1, keepdims=True) \
                if x.shape[-1] > 4 else 0.0
        else:
            tt = (t.to(x.dtype) / 1000.0).reshape(-1, 1, 1, 1)
            cm = ctx.mean(dim=(1, 2)).reshape(-1, 1, 1, 1)
            extra = x[..., 4:].mean(dim=-1, keepdim=True) \
                if x.shape[-1] > 4 else 0.0
        z = x[..., :4]
        return lib.tanh(0.9 * z + tt) + 0.05 * lib.sin(3.0 * z) \
            + 0.1 * cm + 0.1 * extra
    return model_fn


JTOY, TTOY = _toy(jnp), _toy(torch)


def _conds(np_rng, b=2, concat=False):
    """(JAX cond, uncond), (port cond, uncond) on the same numpy data."""
    cc = np_rng.standard_normal((b, 4, 5, 2)).astype(np.float32) \
        if concat else None
    ctx = np_rng.standard_normal((2, b, 3, 6)).astype(np.float32)
    j = tuple(JD.CondBundle(jnp.asarray(c),
                            None if cc is None else jnp.asarray(cc))
              for c in ctx)
    t = tuple(TD.CondBundle(np_t(c), None if cc is None else np_t(cc))
              for c in ctx)
    return j, t


def _ddim_noises(rng, n, shape, inpaint):
    """The JAX ddim_decode's per-step noises: (re-noise stack, sigma
    stack) along its key splits."""
    ren, sig = [], []
    for key in jax.random.split(rng, n):
        if inpaint:
            k_noise, key = jax.random.split(key)
            ren.append(np.asarray(jax.random.normal(k_noise, shape)))
        k_sig, _ = jax.random.split(key)
        sig.append(np.asarray(jax.random.normal(k_sig, shape)))
    return (np_t(np.stack(ren)) if ren else None), np_t(np.stack(sig))


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_make_ddim_params_traced(eta):
    j = JS.make_ddim_params_traced(JSCHED, 50, eta=eta)
    t = TS.make_ddim_params_traced(TSCHED, 50, eta=eta)
    np.testing.assert_array_equal(t.timesteps.numpy(), np.asarray(j.timesteps))
    for f in ("alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-6,
                                   atol=0, err_msg=f)
    assert t.timesteps.dtype == torch.int32 and t.sigmas.dtype == torch.float32


def test_spatial_norm_thresholding_and_distributions(np_rng):
    x = (np_rng.standard_normal((2, 3, 4, 4)) * 2.0).astype(np.float32)
    ref = JSU.spatial_norm_thresholding(jnp.asarray(x), 1.5)
    out = TSU.spatial_norm_thresholding(np_t(x), 1.5)
    assert rel_err(out, ref) < 1e-6
    assert not torch.equal(out, np_t(x))        # some pixels rescaled

    mean, logvar, o_mean, o_logvar, xs = (
        np_rng.standard_normal((2, 3, 4, 4)).astype(np.float32) * s
        for s in (1.0, 0.5, 1.0, 0.5, 1.0))
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, mean.shape))
    pairs = [
        (JDI.sample(jnp.asarray(mean), jnp.asarray(logvar), key),
         TDI.sample(np_t(mean), np_t(logvar), np_t(noise))),
        (JDI.mode(jnp.asarray(mean), jnp.asarray(logvar)),
         TDI.mode(np_t(mean), np_t(logvar))),
        (JDI.kl(jnp.asarray(mean), jnp.asarray(logvar)),
         TDI.kl(np_t(mean), np_t(logvar))),
        (JDI.kl(*map(jnp.asarray, (mean, logvar, o_mean, o_logvar))),
         TDI.kl(*map(np_t, (mean, logvar, o_mean, o_logvar)))),
        (JDI.nll(*map(jnp.asarray, (mean, logvar, xs))),
         TDI.nll(*map(np_t, (mean, logvar, xs)))),
    ]
    for ref, out in pairs:
        assert tuple(out.shape) == tuple(ref.shape)
        assert rel_err(out, ref) < 1e-6


@pytest.mark.parametrize("masked,eta", [(False, 0.0), (True, 0.0),
                                        (True, 0.5)])
def test_ddim_sample_toy(np_rng, masked, eta):
    (jc, ju), (tc, tu) = _conds(np_rng)
    x_T = np_rng.standard_normal(SHAPE).astype(np.float32)
    x0 = np_rng.standard_normal(SHAPE).astype(np.float32) * 0.5
    mask = (np_rng.uniform(size=(1, 4, 5, 1)) > 0.5).astype(np.float32)
    jddim = JS.make_ddim_params_traced(JSCHED, 8, eta=eta)
    tddim = TS.make_ddim_params_traced(TSCHED, 8, eta=eta)
    rng = jax.random.PRNGKey(7)
    ref = JD.ddim_sample(JTOY, JSCHED, jddim, jc, ju, x_T=jnp.asarray(x_T),
                         rng=rng, cfg_scale=5.0,
                         mask=jnp.asarray(mask) if masked else None,
                         x0=jnp.asarray(x0) if masked else None)
    ren, sig = _ddim_noises(rng, 8, SHAPE, masked)
    out = TD.ddim_sample(TTOY, TSCHED, tddim, tc, tu, x_T=np_t(x_T),
                         cfg_scale=5.0, mask=np_t(mask) if masked else None,
                         x0=np_t(x0) if masked else None,
                         renoise_noise=ren, sigma_noise=sig if eta else None)
    assert rel_err(out, ref) < 1e-5


def test_ddim_sample_draws_x_T_in_f32():
    """x_T is drawn in f32 unless a dtype is asked for, whatever the
    contexts' dtype."""
    seen = []

    def model(x, t, ctx, control=None):
        seen.append(x.dtype)
        return torch.zeros_like(x)
    cb = TD.CondBundle(torch.zeros((1, 3, 6), dtype=torch.bfloat16))
    ddim = TS.make_ddim_params_traced(TSCHED, 2)
    out = TD.ddim_sample(model, TSCHED, ddim, cb, cb, shape=(1, 4, 5, 4),
                         generator=torch.Generator().manual_seed(0))
    assert out.dtype == torch.float32 and set(seen) == {torch.float32}
    with pytest.raises(ValueError, match="x_T"):
        TD.ddim_sample(model, TSCHED, ddim, cb, cb, shape=(1, 4, 5, 4))


@pytest.mark.parametrize("indexing,cfg", [("index", 1.0), ("timestep", 1.0),
                                          ("index", 3.0)])
def test_ddim_encode_toy(np_rng, indexing, cfg):
    (jc, ju), (tc, tu) = _conds(np_rng)
    x0 = np_rng.standard_normal(SHAPE).astype(np.float32)
    jddim = JS.make_ddim_params_traced(JSCHED, 10)
    tddim = TS.make_ddim_params_traced(TSCHED, 10)
    ref = JD.ddim_encode(JTOY, JSCHED, jddim, jnp.asarray(x0), jc, ju, 7,
                         cfg_scale=cfg, timestep_indexing=indexing)
    out = TD.ddim_encode(TTOY, TSCHED, tddim, np_t(x0), tc, tu, 7,
                         cfg_scale=cfg, timestep_indexing=indexing)
    assert rel_err(out, ref) < 1e-5
    with pytest.raises(ValueError, match="timestep_indexing"):
        TD.ddim_encode(TTOY, TSCHED, tddim, np_t(x0), tc, tu, 2,
                       timestep_indexing="ddim")


@pytest.mark.parametrize("inpaint,param", [(False, "eps"), (True, "eps"),
                                           (False, "v")])
def test_dpmpp_2m_decode_toy(np_rng, inpaint, param):
    (jc, ju), (tc, tu) = _conds(np_rng)
    x = np_rng.standard_normal(SHAPE).astype(np.float32)
    init = np_rng.standard_normal(SHAPE).astype(np.float32) * 0.5
    nmask = (np_rng.uniform(size=(1, 4, 5, 1)) > 0.5).astype(np.float32)
    gate = np.array([1, 0, 1, 1, 0, 1], np.float32)
    dts = np.asarray(JDPM.uniform_timesteps_desc(JSCHED, 601, 6))
    rng = jax.random.PRNGKey(11)
    kw = dict(init_latent=jnp.asarray(init), nmask=jnp.asarray(nmask),
              renoise_gate=jnp.asarray(gate)) if inpaint else {}
    ref = JDPM.dpmpp_2m_decode(JTOY, JSCHED, jnp.asarray(dts), jnp.asarray(x),
                               jc, ju, cfg_scale=7.0, parameterization=param,
                               rng=rng, **kw)
    tkw = {}
    if inpaint:
        ren = np.stack([np.asarray(jax.random.normal(k, SHAPE))
                        for k in jax.random.split(rng, 6)])
        tkw = dict(init_latent=np_t(init), nmask=np_t(nmask),
                   renoise_gate=gate, renoise_noise=np_t(ren))
    out = TDPM.dpmpp_2m_decode(TTOY, TSCHED, dts, np_t(x), tc, tu,
                               cfg_scale=7.0, parameterization=param, **tkw)
    assert rel_err(out, ref) < 1e-5
    if not inpaint and param == "eps":
        # the multistep engine's DPM++ coefficients are the same steps
        eng = TM.multistep_decode(TTOY, TM.make_dpmpp_coeffs(TSCHED, dts),
                                  np_t(x), tc, tu, cfg_scale=7.0)
        assert rel_err(eng, out) < 1e-5


@pytest.mark.parametrize("param,thresh", [("eps", None), ("v", None),
                                          ("eps", 0.8)])
def test_plms_decode_toy(np_rng, param, thresh):
    (jc, ju), (tc, tu) = _conds(np_rng)
    x = np_rng.standard_normal(SHAPE).astype(np.float32)
    calls = []
    counted = lambda *a: calls.append(1) or TTOY(*a)
    ref = JPL.plms_decode(JTOY, JSCHED, JS.make_ddim_params(JSCHED, 20),
                          jnp.asarray(x), jc, ju, 6, cfg_scale=6.0,
                          parameterization=param, dynamic_threshold=thresh)
    out = TPL.plms_decode(counted, TSCHED, TS.make_ddim_params(TSCHED, 20),
                          np_t(x), tc, tu, 6, cfg_scale=6.0,
                          parameterization=param, dynamic_threshold=thresh)
    assert rel_err(out, ref) < 1e-5
    assert len(calls) == 6 + 1        # the predictor-corrector's extra call


def test_ddpm_functions_toy(np_rng):
    jpc, tpc = JP.posterior_coefs(JSCHED, 0.1), TP.posterior_coefs(TSCHED, 0.1)
    for a, b in zip(tpc, jpc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6)
    x0 = np_rng.standard_normal(SHAPE).astype(np.float32) * 0.7
    xt = np_rng.standard_normal(SHAPE).astype(np.float32)
    t = np.array([0, 613], np.int32)
    pc = JP.posterior_coefs(JSCHED)
    tpc = TP.posterior_coefs(TSCHED)
    jx0, jxt, jt = jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(t)
    tx0, txt, tt = np_t(x0), np_t(xt), torch.from_numpy(t)
    for ref, out in zip(JP.q_mean_variance(JSCHED, jx0, jt),
                        TP.q_mean_variance(TSCHED, tx0, tt)):
        assert rel_err(out, ref) < 1e-6
    assert rel_err(TP.predict_start_from_noise(tpc, txt, tt, tx0),
                   JP.predict_start_from_noise(pc, jxt, jt, jx0)) < 1e-6
    for ref, out in zip(JP.q_posterior(pc, jx0, jxt, jt),
                        TP.q_posterior(tpc, tx0, txt, tt)):
        assert rel_err(out, ref) < 1e-6
    for concat, cfg in ((False, 4.0), (True, 1.0), (True, 4.0)):
        (jc, ju), (tc, tu) = _conds(np_rng, concat=concat)
        for param in ("eps", "v", "x0"):
            kw = dict(cfg_scale=cfg, parameterization=param)
            ref = JP.p_mean_variance(JTOY, JSCHED, pc, jxt, jt, jc, ju, **kw)
            out = TP.p_mean_variance(TTOY, TSCHED, tpc, txt, tt, tc, tu, **kw)
            for r, o in zip(ref, out):
                assert rel_err(o, r) < 1e-5, (concat, cfg, param)
        key = jax.random.PRNGKey(5)
        ref = JP.p_sample(JTOY, JSCHED, pc, jxt, jt, jc, ju, rng=key,
                          cfg_scale=cfg, temperature=0.7)
        noise = np_t(jax.random.normal(key, SHAPE))
        out = TP.p_sample(TTOY, TSCHED, tpc, txt, tt, tc, tu, noise=noise,
                          cfg_scale=cfg, temperature=0.7)
        assert rel_err(out, ref) < 1e-5
        # the noise is zeroed at t == 0 (the batch's first row)
        mean = TP.p_mean_variance(TTOY, TSCHED, tpc, txt, tt, tc, tu,
                                  cfg_scale=cfg)[0]
        assert torch.equal(out[0], mean[0]) and not torch.equal(out[1],
                                                                mean[1])


@pytest.mark.parametrize("T,n", [(1000, 7), (1000, 13), (1000, 100),
                                 (1000, 999), (30, 4), (30, 29)])
def test_ddpm_intermediate_indices(T, n):
    ref = np.asarray(jnp.linspace(0, T - 1, n).astype(jnp.int32))
    np.testing.assert_array_equal(TP.intermediate_indices(T, n), ref)


def test_p_sample_loop_toy(np_rng):
    sched_j = JS.make_linear_schedule(30)
    sched_t = TS.make_linear_schedule(30)
    (jc, ju), (tc, tu) = _conds(np_rng)
    rng = jax.random.PRNGKey(2)
    ref, ref_inter = JP.p_sample_loop(JTOY, sched_j, jc, ju, shape=SHAPE,
                                      rng=rng, cfg_scale=3.0,
                                      return_intermediates=4)
    k0, rest = jax.random.split(rng)
    x_T = np_t(jax.random.normal(k0, SHAPE))
    noise = np_t(np.stack([np.asarray(jax.random.normal(k, SHAPE))
                           for k in jax.random.split(rest, 30)]))
    out, inter = TP.p_sample_loop(TTOY, sched_t, tc, tu, x_T=x_T, noise=noise,
                                  cfg_scale=3.0, return_intermediates=4)
    assert rel_err(out, ref) < 1e-4
    assert tuple(inter.shape) == tuple(ref_inter.shape) == (4,) + SHAPE
    assert rel_err(inter, ref_inter) < 1e-4
    # a generator draws x_T and every step's noise itself
    a = TP.p_sample_loop(TTOY, sched_t, tc, tu, shape=SHAPE,
                         generator=torch.Generator().manual_seed(1))
    b = TP.p_sample_loop(TTOY, sched_t, tc, tu, shape=SHAPE,
                         generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and torch.isfinite(a).all()


# ---------------------------------------------------------------------------
# the small UNet
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unet():
    (ju, jv, _), (up, vp, _) = jax_models(seed=3)
    tu, tv, _ = torch_configs()
    jit = jax.jit(lambda p, x, t, c: JU.unet_apply(p, ju, x, t, c)[0])
    jfn = lambda x, t, c, control=None: jit(up, x, t, c)
    tp = to_port(up)
    tfn = lambda x, t, c, control=None: TU.unet_apply(tp, tu, x, t, c)[0]
    return jfn, tfn, (to_port(vp), tv)


def _psnr(a, b):
    mse = float(torch.mean((a.double() - b.double()) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(4.0 / mse)


@pytest.mark.parametrize("sampler", ["dpmpp", "plms", "ddpm"])
def test_samplers_on_unet(unet, np_rng, sampler):
    """The samplers with no facade on the small UNet (``ddim_sample`` and
    ``ddim_encode`` run on it through ``txt2img`` and ``img2img_invert``
    in test_torch_specializations.py)."""
    jfn, tfn, (vp, tv) = unet
    shape = (1, 8, 12, 4)
    x = np_rng.standard_normal(shape).astype(np.float32)
    ctx = np_rng.standard_normal((2, 1, 7, 64)).astype(np.float32)
    jc, ju = (JD.CondBundle(jnp.asarray(c)) for c in ctx)
    tc, tu = (TD.CondBundle(np_t(c)) for c in ctx)
    jx, tx = jnp.asarray(x), np_t(x)
    if sampler == "dpmpp":
        dts = np.asarray(JDPM.uniform_timesteps_desc(JSCHED, 501, 3))
        ref = JDPM.dpmpp_2m_decode(jfn, JSCHED, jnp.asarray(dts), jx, jc, ju)
        out = TDPM.dpmpp_2m_decode(tfn, TSCHED, dts, tx, tc, tu)
    elif sampler == "plms":
        ref = JPL.plms_decode(jfn, JSCHED, JS.make_ddim_params(JSCHED, 20),
                              jx, jc, ju, 3)
        out = TPL.plms_decode(tfn, TSCHED, TS.make_ddim_params(TSCHED, 20),
                              tx, tc, tu, 3)
    else:
        sj, st = JS.make_linear_schedule(4), TS.make_linear_schedule(4)
        rng = jax.random.PRNGKey(4)
        ref = JP.p_sample_loop(jfn, sj, jc, ju, x_T=jx, rng=rng,
                               cfg_scale=5.0)
        noise = np.stack([np.asarray(jax.random.normal(k, shape))
                          for k in jax.random.split(rng, 4)])
        out = TP.p_sample_loop(tfn, st, tc, tu, x_T=tx, noise=np_t(noise),
                               cfg_scale=5.0)
    ref = np_t(ref)
    err = rel_err(out, ref)
    psnr = _psnr(TV.decode(vp, tv, out), TV.decode(vp, tv, ref))
    print(f"\n[{sampler}] small UNet: latent rel err {err:.2e}, decoded "
          f"PSNR {psnr:.1f} dB")
    assert err <= 1e-4 and psnr >= 80.0
