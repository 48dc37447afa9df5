"""Port parity: tensor x data parallel fine-tuning — ``parallel/sharding.py``
(the UNet's 'tp' layout, ``shard_params`` / ``gather_params``),
``unet_apply(tp=)`` and the sharded train step (``shard_train_state``,
``make_train_step``) — on gloo ranks on the CPU, against the JAX
package's GSPMD counterparts on its 8-device virtual CPU mesh
(``tests/conftest.py``), on JAX's tiny UNet (``tests/test_parallel.py``:
16 channels, mult (1, 2), attention at 1, 2 heads, context 32).

The ranks are spawned processes (``tests/torch_parallel_ranks.py``, no
JAX import): world 2 as a (1, 2) ('dp', 'tp') mesh, world 4 as (2, 2),
running while JAX computes its side here. Tolerances: the
forward rtol 5e-4, atol 5e-5 (JAX's own sharded-forward test); the train
steps those of ``tests/test_torch_train.py`` (losses 1e-5 relative,
params and EMA 1e-5 of each leaf's largest entry; Adam eps 1e-6 and the
all-zero leaves filled, for the reasons given there); the layout bit for
bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sd_animation_optical_flow_tpu.diffusion import schedule as JSC
from sd_animation_optical_flow_tpu.models import unet as JU
from sd_animation_optical_flow_tpu.models.layers import numpy_init
from sd_animation_optical_flow_tpu.parallel import mesh as JM
from sd_animation_optical_flow_tpu.parallel import sharding as JSH
from sd_animation_optical_flow_tpu.training import optim as JO
from sd_animation_optical_flow_tpu.training import train_step as JT
from sd_animation_optical_flow_tpu_torch.diffusion import schedule as TSC
from sd_animation_optical_flow_tpu_torch.models import unet as TU
from sd_animation_optical_flow_tpu_torch.training import optim as TO
from sd_animation_optical_flow_tpu_torch.training import train_step as TT
from sd_animation_optical_flow_tpu_torch.utils.jax_params import \
    train_state_from_jax
from sd_animation_optical_flow_tpu_torch.utils.tree import tree_map
from torch_parallel_ranks import Ranks
from torch_port_common import (close_tree, fill_zero_leaves, jax_t_noise,
                               perturb_zero_convs, to_port)

TINY = dict(model_channels=16, channel_mult=(1, 2),
            attention_resolutions=(1,), num_heads=2, context_dim=32)
FWD_TOL = dict(rtol=5e-4, atol=5e-5)
TRAIN_TOL = 1e-5
OPT = dict(lr=1e-5, eps=1e-6)       # tests/test_torch_train.py's
T = 1000
WORLDS = (2, 4)
STEPS = 3


def _tiny(seed):
    cfg = JU.UNetConfig(**TINY)
    with numpy_init():
        params = JU.unet_init(jax.random.PRNGKey(seed), cfg)
    return cfg, perturb_zero_convs(params, np.random.default_rng(seed + 1))


@pytest.fixture(scope="module")
def cases():
    jcfg, params = _tiny(0)
    rng = np.random.default_rng(2)
    fwd = {"x": rng.standard_normal((8, 8, 8, 4), dtype=np.float32),
           "t": np.arange(8, dtype=np.int64) * 120,
           "ctx": rng.standard_normal((8, 7, 32), dtype=np.float32)}
    tparams = fill_zero_leaves(params, np.random.default_rng(3))
    x0 = rng.standard_normal((8, 8, 8, 4), dtype=np.float32)
    ctx = rng.standard_normal((8, 7, 32), dtype=np.float32)
    key = jax.random.PRNGKey(7)      # fixed t / noise: a loss to memorise
    t, noise = jax_t_noise(key, x0, T)
    return {"jax": (jcfg, params, tparams, (x0, ctx, key)),
            "tp": {"cfg": TU.UNetConfig(**TINY), "params": to_port(params),
                   **fwd},
            "train": {"cfg": TU.UNetConfig(**TINY),
                      "sched": TSC.make_linear_schedule(T),
                      "params": to_port(tparams), "opt": OPT,
                      "batches": [(x0, ctx, t.numpy(), noise.numpy())]
                      * STEPS}}


def _jax_forward(cases):
    """JAX's unsharded forward, and its GSPMD forward on the (4, 2) mesh
    of its own test."""
    jcfg, params, _, _ = cases["jax"]
    fwd = cases["tp"]
    apply = jax.jit(lambda p, x, t, c: JU.unet_apply(p, jcfg, x, t, c)[0])
    args = [jnp.asarray(fwd[k]) for k in ("x", "t", "ctx")]
    refs = {"unsharded": np.asarray(apply(params, *args))}
    m = JM.make_mesh(dp=4, tp=2)
    p_sh, _ = JSH.shard_params(params, m)
    batch = lambda a: jax.device_put(a, NamedSharding(
        m, P("dp", *[None] * (a.ndim - 1))))
    refs["gspmd"] = np.asarray(apply(p_sh, *map(batch, args)))
    refs["specs"] = JSH.unet_param_specs(params)
    return refs


def _jax_train(cases):
    """Three steps of JAX's sharded train step on a (2, 2) mesh (the
    ranks' shape) from the train params, the batch and rng fixed: the
    losses, the params and EMA after step 3, and the state after step 2
    carried into the port (``train_state_from_jax``), as the resumed
    run's input: its params and ``opt.state_dict()``."""
    jcfg, _, tparams, (x0, ctx, key) = cases["jax"]
    tx = JO.adamw_with_ema_wings(**OPT)
    m = JM.make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    # a copy per leaf: the wings' EMA starts as the params' own buffers,
    # and the step donates both
    state = jax.tree.map(jnp.copy, JT.init_train_state(
        jax.tree.map(jnp.asarray, tparams), tx))
    state = JT.shard_train_state(state, m)
    step = JT.make_train_step(jcfg, JSC.make_linear_schedule(T), tx)
    xs = jax.device_put(jnp.asarray(x0), JM.batch_sharding(m))
    cs = jax.device_put(jnp.asarray(ctx), NamedSharding(m, P("dp", None,
                                                             None)))
    losses = []
    for i in range(STEPS):
        if i == STEPS - 1:      # the step donates its input state
            after = jax.tree.map(np.asarray, state)
        state, loss = step(state, xs, cs, key)
        losses.append(float(loss))
    port = train_state_from_jax(
        after.params, after.opt_state,
        functools.partial(TO.adamw_with_ema_wings, **OPT),
        step=int(after.step), device="cpu")
    resume = {"params": tree_map(lambda p: p.detach(), port.params),
              "opt": port.opt.state_dict(), "step": port.step,
              "ema_step": port.opt.ema_step}
    return (losses, jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, JO.ema_params_of(state.opt_state))), \
        resume


@pytest.fixture(scope="module")
def runs(cases, tmp_path_factory):
    """({world: {job: [rank 0's result, ...]}}, JAX's results). World 2
    starts first; world 4 takes the JAX state after step 2, so it starts
    once JAX has trained, and runs while JAX's forwards compile."""
    mk = lambda world, jobs, inputs: Ranks(
        world, tmp_path_factory.mktemp(f"tp{world}"), jobs, inputs)
    started = {2: mk(2, ["tp_jobs"], {"tp": cases["tp"]})}
    train, resume = _jax_train(cases)
    started[4] = mk(4, ["tp_jobs", "tp_train"],
                    {"tp": cases["tp"],
                     "train": {**cases["train"], "resume": resume}})
    refs = {**_jax_forward(cases), "train": train}
    return {world: r.results() for world, r in started.items()}, refs


def test_specs_are_jax_specs_in_the_port_layout(cases, runs):
    """Leaf for leaf, the port's spec is JAX's ``unet_param_specs`` of the
    same tree reversed ([in, out] -> [out, in]); every rule is met."""
    ranks, refs = runs
    specs = ranks[2]["tp_jobs"][0]["specs"]
    seen = set()

    def check(leaf, spec, jspec):
        assert spec == tuple(reversed(tuple(jspec))), (spec, jspec)
        seen.add(spec)
    tree_map(check, cases["tp"]["params"], specs, refs["specs"])
    assert seen == {("tp", None), (None, "tp"), ("tp",), ()}


@pytest.mark.parametrize("world", WORLDS)
def test_shard_then_gather_round_trips(cases, runs, world):
    """gather_params(shard_params(p)) is p bit for bit on every rank; a
    rank's GEGLU rows are its slice of the value rows, then its slice of
    the gate rows; a stepped AdamW state shards the same way (moments
    gathered back equal, the step counts whole, the same
    hyperparameters)."""
    w = cases["tp"]["params"]["input_blocks"][1]["transformer"]["blocks"][
        0]["ff_proj"]["w"].numpy()
    value, gate = np.split(w, 2)
    for r in runs[0][world]["tp_jobs"]:
        assert r["round_trip"] and r["adamw_sharded"]
        k, i = value.shape[0] // 2, r["tp_rank"]
        np.testing.assert_array_equal(
            r["ff_proj"], np.concatenate([value[i * k:(i + 1) * k],
                                          gate[i * k:(i + 1) * k]]))


@pytest.mark.parametrize("world", WORLDS)
def test_tp_forward_matches_jax(runs, world):
    """``unet_apply(tp=)`` on the local params (each 'dp' rank its batch
    slice, gathered) against JAX's unsharded forward and its GSPMD
    forward on the (4, 2) mesh."""
    ranks, refs = runs
    for r in ranks[world]["tp_jobs"]:
        np.testing.assert_allclose(r["out"], refs["unsharded"], **FWD_TOL)
        np.testing.assert_allclose(r["out"], refs["gspmd"], **FWD_TOL)


@pytest.mark.parametrize("run", ["fresh", "resume"])
def test_sharded_train_steps_match_jax(runs, run):
    """At dp 2 x tp 2 against JAX's step under its ``shard_train_state`` on
    a (2, 2) mesh: three steps from the params ("fresh"), or JAX's state
    after two steps carried across by ``train_state_from_jax`` (params,
    AdamW moments and counts, the EMA) and sharded, then the third
    ("resume"). The losses on every rank, the gathered params and EMA
    after step 3; fresh, the loss decreases (the batch, t and noise are
    the same each step: JAX's own test's memorising objective)."""
    ranks, refs = runs
    jlosses, jparams, jema = refs["train"]
    res = [r[run] for r in ranks[4]["tp_train"]]
    for r in res:
        np.testing.assert_allclose(r["losses"], jlosses[STEPS -
                                                        len(r["losses"]):],
                                   rtol=TRAIN_TOL)
        assert r["step"] == STEPS and r["ema_step"] == STEPS
    if run == "fresh":
        assert res[0]["losses"][-1] < res[0]["losses"][0]
    close_tree(res[0]["params"], jparams, TRAIN_TOL, "param")
    close_tree(res[0]["ema"], jema, TRAIN_TOL, "ema")


@pytest.mark.parametrize("run", ["fresh", "resume"])
def test_whole_leaves_get_equal_gradients_on_every_tp_rank(runs, run):
    """The replicated leaves' gradients after the last step: equal on the
    two 'tp' ranks of each 'dp' rank from the collectives of the forward
    alone (no extra all-reduce), and over 'dp' after the mean."""
    res = runs[0][4]["tp_train"]
    grads = [r[run]["whole_grads"] for r in res]
    assert {(r["dp_rank"], r["tp_rank"]) for r in res} == \
        {(0, 0), (0, 1), (1, 0), (1, 1)}
    assert len(grads[0]) > 0
    for g in grads[1:]:
        assert len(g) == len(grads[0])
        for a, b in zip(g, grads[0]):
            assert torch.equal(a, b)


def test_tp_refusals(runs):
    """Heads that do not divide over 'tp' and tp with sp raise ValueError
    in the ranks; a mesh that is not a DeviceMesh raises TypeError."""
    for world in WORLDS:
        for r in runs[0][world]["tp_jobs"]:
            heads, sp = r["refusals"]
            assert "do not divide" in heads and "does not compose" in sp
    params = TT.trainable({"w": torch.zeros(2, 2)})
    state = TT.TrainState(params, TO.adamw_with_ema_wings([params["w"]]))
    with pytest.raises(TypeError, match="DeviceMesh"):
        TT.shard_train_state(state, mesh="tp")
    with pytest.raises(TypeError, match="DeviceMesh"):
        TU.TensorParallelConfig(mesh=object())


@pytest.mark.parametrize("kernel,dim,fused", [
    ("linear_ln", 960, True), ("linear_ln", 120, False),
    ("linear_ln", 40, False), ("geglu", 1280, True), ("geglu", 160, False)])
def test_fused_route_sends_local_shapes_to_plain(kernel, dim, fused):
    """SD's 320 channels: the whole QKV (960 columns) and GEGLU (dff 1280)
    take kernels #3 / #4; at tp = 8 the local QKV (120), Q (40) and dff
    (160) do not fit them and take the plain chain."""
    x = torch.zeros((2, 2048, 320), dtype=torch.bfloat16)
    kw = {"dout": dim} if kernel == "linear_ln" else {"dff": dim}
    assert TU._fused_route(x, **kw) is fused
