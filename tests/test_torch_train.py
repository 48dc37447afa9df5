"""Port parity: the diffusion fine-tuning step (``training/``) against the
JAX package on the CPU, in f32, on the small UNet (``UNET_KW``, latent
16x16, batch 2) with shared weights.

The JAX ``p_losses`` draws t and the noise from its rng key; the port
takes them as inputs, rebuilt here along the JAX key split
(``k_t, k_noise = split(rng)``, then ``randint``, then ``normal``).
Tolerances: the loss within 1e-5 relative, every gradient leaf within
1e-4 of its largest entry, parameters and EMA after three optimizer
steps within 1e-5 of their largest entry (f32 sums in another order).
Each JAX program is jitted once per module (~15-25 s on this CPU)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu.diffusion import schedule as JS
from sd_animation_optical_flow_tpu.models import unet as JU
from sd_animation_optical_flow_tpu.models.layers import numpy_init
from sd_animation_optical_flow_tpu.training import ema as JE
from sd_animation_optical_flow_tpu.training import losses as JL
from sd_animation_optical_flow_tpu.training import optim as JO
from sd_animation_optical_flow_tpu.training import train_step as JT
from sd_animation_optical_flow_tpu_torch.diffusion import schedule as TS
from sd_animation_optical_flow_tpu_torch.models import unet as TU
from sd_animation_optical_flow_tpu_torch.training import ema as TE
from sd_animation_optical_flow_tpu_torch.training import losses as TL
from sd_animation_optical_flow_tpu_torch.training import optim as TO
from sd_animation_optical_flow_tpu_torch.training import train_step as TT
from sd_animation_optical_flow_tpu_torch.utils.jax_params import \
    train_state_from_jax
from sd_animation_optical_flow_tpu_torch.utils.tree import (tree_leaves,
                                                            tree_map)
from torch_port_common import (UNET_KW, close_tree, fill_zero_leaves,
                               jax_models, jax_t_noise, np_t,
                               perturb_zero_convs, to_port)

T = 1000
# SD fine-tuning's learning rate. Adam divides by sqrt(nu) + eps, so an
# element whose gradient is f32 noise (structurally zero in this
# 32-channel UNet: a per-channel shift before a one-channel GroupNorm
# group) would take a noise-signed step of ~lr in each framework at the
# default eps 1e-8; eps 1e-6 keeps such steps below the tolerance and
# leaves every real gradient's step unchanged to 1%
OPT = dict(lr=1e-5, eps=1e-6)
JSCHED, TSCHED = JS.make_linear_schedule(T), TS.make_linear_schedule(T)
JVG = jax.jit(jax.value_and_grad(JL.p_losses),
              static_argnames=("unet_cfg", "parameterization"))


def _batch(seed, c_concat=0):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((2, 16, 16, 4), dtype=np.float32)
    ctx = rng.standard_normal((2, 7, UNET_KW["context_dim"]),
                              dtype=np.float32)
    cc = rng.standard_normal((2, 16, 16, c_concat), dtype=np.float32) \
        if c_concat else None
    return x0, ctx, cc


@pytest.fixture(scope="module")
def models():
    cfgs, (unet_p, _, _) = jax_models(0)
    cfg9 = JU.UNetConfig(**UNET_KW, in_channels=9)
    with numpy_init():
        unet9 = JU.unet_init(jax.random.PRNGKey(9), cfg9)
    perturb_zero_convs(unet9, np.random.default_rng(9))
    return {4: (cfgs[0], unet_p, TU.UNetConfig(**UNET_KW)),
            9: (cfg9, unet9, TU.UNetConfig(**UNET_KW, in_channels=9))}


@pytest.mark.parametrize("parameterization,channels", [
    ("eps", 4), ("v", 4), ("x0", 4), ("eps", 9)])
def test_p_losses_value_and_grad_match_jax(models, parameterization,
                                           channels):
    """The loss and every parameter gradient against
    ``jax.value_and_grad(p_losses)``; 9 channels: the inpainting UNet with
    a 5-channel ``c_concat``."""
    jcfg, jparams, tcfg = models[channels]
    x0, ctx, cc = _batch(channels, c_concat=channels - 4)
    rng = jax.random.PRNGKey(3)
    jloss, jgrads = JVG(jparams, jcfg, JSCHED, jnp.asarray(x0),
                        jnp.asarray(ctx), rng,
                        parameterization=parameterization,
                        c_concat=None if cc is None else jnp.asarray(cc))
    params = TT.trainable(to_port(jparams))
    t, noise = jax_t_noise(rng, x0)
    loss = TL.p_losses(params, tcfg, TSCHED, np_t(x0), np_t(ctx), t, noise,
                       parameterization=parameterization,
                       c_concat=None if cc is None else np_t(cc))
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    gtree = tree_map(lambda _: next(it), params)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    close_tree(gtree, jgrads, 1e-4, "grad")


@pytest.fixture(scope="module")
def jax_run(models):
    """Three JAX train steps with ``adamw_with_ema_wings`` from the small
    UNet's weights: the starting params (numpy), the batches, the losses,
    the state after step 2 (numpy) and after step 3."""
    jcfg, _, _ = models[4]
    jparams = fill_zero_leaves(models[4][1], np.random.default_rng(5))
    tx = JO.adamw_with_ema_wings(**OPT)
    step = JT.make_train_step(jcfg, JSCHED, tx)
    # a copy per leaf: the wings' EMA starts as the params' own buffers,
    # and the step donates both
    state = jax.tree.map(jnp.copy, JT.init_train_state(
        jax.tree.map(jnp.asarray, jparams), tx))
    batches, losses, after2 = [], [], None
    for i in range(3):
        x0, ctx, _ = _batch(20 + i)
        rng = jax.random.PRNGKey(30 + i)
        if i == 2:      # the step donates its input state
            after2 = jax.tree.map(np.asarray, state)
        state, loss = step(state, jnp.asarray(x0), jnp.asarray(ctx), rng)
        batches.append((x0, ctx, rng))
        losses.append(float(loss))
    return jparams, batches, losses, after2, jax.tree.map(np.asarray, state)


def _port_step(state, batch):
    x0, ctx, rng = batch
    t, noise = jax_t_noise(rng, x0)
    step = TT.make_train_step(TU.UNetConfig(**UNET_KW), TSCHED)
    return step(state, np_t(x0), np_t(ctx), t, noise).item()


def test_train_steps_with_ema_wings_match_optax(jax_run):
    """Three ``make_train_step`` steps with ``adamw_with_ema_wings``
    against the JAX step with the optax transformation: losses, params
    and the EMA shadow."""
    jparams, batches, jlosses, _, jstate = jax_run
    state = TT.init_train_state(to_port(jparams), functools.partial(
        TO.adamw_with_ema_wings, **OPT))
    losses = [_port_step(state, b) for b in batches]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert state.step == 3 and state.opt.ema_step == 3
    close_tree(state.params, jstate.params, 1e-5, "param")
    close_tree(TO.ema_params_of(state.opt, state.params),
                JO.ema_params_of(jstate.opt_state), 1e-5, "ema")


def test_train_state_from_jax_resumes(jax_run):
    """JAX takes two steps; the port carries that state (params, adamw
    moments and count, EMA wings) over and takes the third step, landing
    where JAX's third step does."""
    _, batches, jlosses, after2, jstate = jax_run
    state = train_state_from_jax(
        after2.params, after2.opt_state,
        functools.partial(TO.adamw_with_ema_wings, **OPT),
        step=int(after2.step), device="cpu")
    assert state.step == 2 and state.opt.ema_step == 2
    loss = _port_step(state, batches[2])
    assert abs(loss - jlosses[2]) <= 1e-5 * abs(jlosses[2])
    close_tree(state.params, jstate.params, 1e-5, "param")
    close_tree(TO.ema_params_of(state.opt, state.params),
                JO.ema_params_of(jstate.opt_state), 1e-5, "ema")


def test_ema_update_matches_jax():
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((3, 5), dtype=np.float32),
            "b": [rng.standard_normal(4, dtype=np.float32)]}
    jstate = JE.ema_init(jax.tree.map(jnp.asarray, tree))
    tstate = TE.ema_init(tree_map(torch.from_numpy, tree))
    for i in range(3):
        new = jax.tree.map(lambda a: a + np.float32(i + 1), tree)
        jstate = JE.ema_update(jstate, jax.tree.map(jnp.asarray, new), 0.9)
        tstate = TE.ema_update(tstate, tree_map(torch.from_numpy, new), 0.9)
    assert tstate.num_updates == int(jstate.num_updates) == 3
    for a, b in zip(tree_leaves(TE.ema_params(tstate)),
                    jax.tree.leaves(JE.ema_params(jstate))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_unported_training_options_raise(models):
    """Sharding the train state over anything but a torch DeviceMesh is
    refused (TypeError; the sharded step itself is held to JAX in
    tests/test_torch_sharding.py); class labels ``y`` give the JAX
    loss."""
    ycfg = dict(UNET_KW, channel_mult=(1, 2), attention_resolutions=(1,),
                num_classes=4)
    with numpy_init():
        yparams = JU.unet_init(jax.random.PRNGKey(7), JU.UNetConfig(**ycfg))
    perturb_zero_convs(yparams, np.random.default_rng(7))
    x0, ctx, _ = _batch(7)
    x0 = x0[:, :8, :8]
    rng = jax.random.PRNGKey(5)
    jloss = jax.jit(JL.p_losses, static_argnames="unet_cfg")(
        yparams, JU.UNetConfig(**ycfg), JSCHED, jnp.asarray(x0),
        jnp.asarray(ctx), rng, y=jnp.array([3, 0]))
    t, noise = jax_t_noise(rng, x0)
    loss = TL.p_losses(to_port(yparams), TU.UNetConfig(**ycfg), TSCHED,
                       np_t(x0), np_t(ctx), t, noise, y=torch.tensor([3, 0]))
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    params = TT.trainable(to_port(models[4][1]))
    state = TT.TrainState(params, TT.make_optimizer(tree_leaves(params)))
    with pytest.raises(TypeError, match="DeviceMesh"):
        TT.shard_train_state(state, mesh=None)
