"""The learner's side of the PyTorch port vs the JAX package's.

- TrainInterface (madrona_tpu_torch.interop): the slot names, shapes and
  dtype names of step_inputs and step_outputs equal the JAX one's for
  Cartpole, Hanabi and Overcooked (the JAX sims are built at 4 worlds
  and never stepped: nothing compiles); torch_step equals sim.step bit
  for bit; a tensor on another device raises.
- examples/torch_train_ppo.py against examples/train_ppo.py on weights
  carried across (mlp_from_numpy of init_mlp's arrays): the MLP's
  outputs within 1e-6 (absolute and relative); gae, ppo_loss, its
  gradients and four Adam epochs (moments from zero) on a fixed seeded
  batch with non-constant advantages within 1e-5 relative (absolute
  1e-5 of the largest reference entry of the gradient; of the largest
  parameter after the Adam epochs, where a near-zero gradient enters
  its own step at full relative size: 8.3e-7 seen against 1.14). Those
  JAX formulas are closures inside make_train, so this file restates
  them with jax, line for line (train_ppo.py:103-113 gae, :115-132
  loss_fn, :146-171 adam_step).
- The port's learners learn on the CPU as the JAX tests ask
  (tests/test_train_ppo.py): PPO on Cartpole at 64 worlds over 120
  updates ends above max(40, 1.5 x its length at update 10)
  (make_train seed 1, as the JAX test; the actions' generator seeded
  101, main's seed + 100); REINFORCE through TrainInterface at 64
  worlds, 25 updates, horizon 48 ends above 40. One PPO update of the
  Overcooked learner at 8 worlds: finite, and the parameters move.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.interop import TrainInterface as JTrainInterface
from madrona_tpu.models.base import make_sim as j_make_sim
from madrona_tpu.models.cartpole import Cartpole as JCartpole
from madrona_tpu.models.hanabi import Hanabi as JHanabi
from madrona_tpu.models.overcooked import Overcooked as JOvercooked
from madrona_tpu_torch import make_sim
from madrona_tpu_torch.interop import TrainInterface
from madrona_tpu_torch.models.cartpole import Cartpole
from madrona_tpu_torch.models.hanabi import Hanabi
from madrona_tpu_torch.models.overcooked import Overcooked

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import torch_train_ppo as P                    # noqa: E402
import torch_train_ppo_overcooked as PO        # noqa: E402
import torch_train_reinforce as R              # noqa: E402
from train_ppo import PPOConfig, init_mlp, mlp  # noqa: E402

torch.set_num_threads(1)

ENVS = {
    "cartpole": (JCartpole, Cartpole),
    "hanabi": (lambda: JHanabi(3, "card_knowledge"),
               lambda: Hanabi(3, "card_knowledge")),
    "overcooked": (lambda: JOvercooked("asymmetric_advantages"),
                   lambda: Overcooked("asymmetric_advantages")),
}


def _specs(slots):
    """{slot: (shape, dtype name)} of a TrainInterface's slots."""
    out = {}
    for k, v in slots.items():
        shape, dtype = v if isinstance(v, tuple) else (v.shape, v.dtype)
        out[k] = (tuple(shape), str(dtype).replace("torch.", "")
                  if isinstance(dtype, torch.dtype) else np.dtype(dtype).name)
    return out


@pytest.mark.parametrize("name", sorted(ENVS))
def test_train_interface(name):
    make_j, make_t = ENVS[name]
    w = 4
    jti = JTrainInterface(j_make_sim(make_j(), num_worlds=w, seed=2,
                                     donate=False))
    ti = TrainInterface(make_sim(make_t(), num_worlds=w, seed=2,
                                 device="cpu"))
    assert _specs(ti.step_inputs) == _specs(jti.step_inputs)
    assert _specs(ti.step_outputs) == _specs(jti.step_outputs)

    # torch_step == sim.step, bit for bit, and hands back the state's own
    # tensors
    sim = make_sim(make_t(), num_worlds=w, seed=2, device="cpu")
    acts = ti.sim.env.random_actions(np.random.RandomState(0), 12, w)
    reset = torch.zeros((w,), dtype=torch.int32)
    for t in range(12):
        got = ti.torch_step(action=acts[t], reset=reset)
        ref = sim.step({"action": acts[t], "reset": reset})
        assert set(got) == set(ref)
        for k in ref:
            assert torch.equal(got[k], ref[k]), (t, k)
            assert got[k] is ti.step_outputs[k]
    with pytest.raises(ValueError, match="the sim is on cpu"):
        ti.torch_step(action=acts[0].to("meta"), reset=reset)
    with pytest.raises(TypeError):
        ti.torch_step(action=acts[0].numpy(), reset=reset)


def _jax_params(seed, sizes):
    return init_mlp(jax.random.PRNGKey(seed), sizes)


def _np(params):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in params]


@pytest.mark.parametrize("sizes", [[4, 64, 64, 2], [320, 128, 128, 6]])
def test_mlp_matches_jax(sizes):
    params = _jax_params(3, sizes)
    x = np.random.RandomState(0).randn(16, 2, sizes[0]).astype(np.float32)
    got = P.mlp_from_numpy(_np(params))(torch.from_numpy(x))
    ref = np.asarray(mlp(params, jnp.asarray(x)))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-6,
                               atol=1e-6)


# ------------------------------------ the JAX example's formulas, restated

CFG = PPOConfig()


def j_gae(frames, last_val, cfg=CFG):
    """train_ppo.py:103-113."""
    def scan_back(carry, fr):
        adv = fr["rew"] + cfg.gamma * (1 - fr["done"]) * carry[1] \
            - fr["val"] + cfg.gamma * cfg.lam * (1 - fr["done"]) * carry[0]
        return (adv, fr["val"]), adv

    (_, _), advs = jax.lax.scan(
        scan_back, (jnp.zeros_like(last_val), last_val), frames,
        reverse=True)
    return advs


def j_loss_fn(params, batch, cfg=CFG):
    """train_ppo.py:115-132 (policy_logits and value are mlp)."""
    pi_p, v_p = params
    logits = mlp(pi_p, batch["obs"])
    logp_all = jax.nn.log_softmax(logits)
    logp = jnp.take_along_axis(logp_all, batch["act"][..., None],
                               axis=-1)[..., 0]
    ratio = jnp.exp(logp - batch["logp"])
    adv = batch["adv"]
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    pg = -jnp.minimum(
        ratio * adv, jnp.clip(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv,
    ).mean()
    v = mlp(v_p, batch["obs"])[..., 0]
    v_loss = jnp.mean((v - batch["ret"]) ** 2)
    ent = -jnp.sum(jnp.exp(logp_all) * logp_all, axis=-1).mean()
    return pg + cfg.vf_coef * v_loss - cfg.ent_coef * ent


def j_adam_epochs(params, batch, cfg=CFG):
    """train_ppo.py:146-171: epochs of adam_step from zero moments."""
    def adam_step(carry, t):
        params, m, v = carry
        grads = jax.grad(j_loss_fn)(params, batch)
        m = jax.tree_util.tree_map(lambda a, g: 0.9 * a + 0.1 * g, m, grads)
        v = jax.tree_util.tree_map(
            lambda a, g: 0.999 * a + 0.001 * g * g, v, grads)
        mh = jax.tree_util.tree_map(lambda a: a / (1 - 0.9 ** (t + 1.0)), m)
        vh = jax.tree_util.tree_map(
            lambda a: a / (1 - 0.999 ** (t + 1.0)), v)
        params = jax.tree_util.tree_map(
            lambda p, a, b: p - cfg.lr * a / (jnp.sqrt(b) + 1e-8),
            params, mh, vh)
        return (params, m, v), None

    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    (params, _, _), _ = jax.lax.scan(
        adam_step, (params, zeros, zeros),
        jnp.arange(cfg.epochs, dtype=jnp.float32))
    return params


def _batch(t=16, w=32, agents=2, d=20, n_act=6):
    """A fixed batch: obs, actions, old log-probs, non-constant
    advantages and returns."""
    rs = np.random.RandomState(11)
    shape = (t, w, agents)
    return dict(
        obs=rs.randn(*shape, d).astype(np.float32),
        act=rs.randint(0, n_act, shape).astype(np.int32),
        logp=np.log(rs.uniform(0.05, 0.6, shape)).astype(np.float32),
        adv=(3.0 * rs.randn(*shape) + 0.7).astype(np.float32),
        ret=(2.0 * rs.randn(*shape)).astype(np.float32),
    )


def _close(got, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(got), ref, rtol=1e-5,
        atol=1e-5 * max(float(np.abs(ref).max()), 1e-30), err_msg=what)


def test_gae_matches_jax():
    rs = np.random.RandomState(5)
    t, w = 24, 64
    rew = rs.randn(t, w).astype(np.float32)
    done = (rs.rand(t, w) < 0.1).astype(np.float32)
    val = rs.randn(t, w).astype(np.float32)
    last = rs.randn(w).astype(np.float32)
    ref = j_gae({"rew": jnp.asarray(rew), "done": jnp.asarray(done),
                 "val": jnp.asarray(val)}, jnp.asarray(last))
    got = P.gae(*(torch.from_numpy(a) for a in (rew, done, val, last)), CFG)
    _close(got.numpy(), ref, "gae")


@pytest.mark.parametrize("part", ["loss", "grads", "adam_epochs"])
def test_ppo_update_matches_jax(part):
    d, n_act = 20, 6
    batch = _batch(d=d, n_act=n_act)
    pi_p = _jax_params(0, [d, 32, 32, n_act])
    v_p = _jax_params(1, [d, 32, 32, 1])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["act"] = tb["act"].long()
    pi, v = P.mlp_from_numpy(_np(pi_p)), P.mlp_from_numpy(_np(v_p))
    names = [(i, k) for k in ("w", "b") for i in range(3)]  # parameters()

    def flat(jparams):
        return [jparams[0][i][k] for i, k in names] \
            + [jparams[1][i][k] for i, k in names]

    if part == "loss":
        _close(float(P.ppo_loss(pi, v, tb, CFG).detach()),
               j_loss_fn((pi_p, v_p), jb), "loss")
    elif part == "grads":
        loss = P.ppo_loss(pi, v, tb, CFG)
        got = torch.autograd.grad(loss, list(pi.parameters())
                                  + list(v.parameters()))
        ref = flat(jax.grad(j_loss_fn)((pi_p, v_p), jb))
        for g, r, n in zip(got, ref, names * 2):
            _close(g.numpy(), r, f"grad {n}")
    else:
        P.adam_epochs(pi, v, tb, CFG)
        ref = flat(j_adam_epochs((pi_p, v_p), jb))
        got = list(pi.parameters()) + list(v.parameters())
        start = flat((pi_p, v_p))
        # Adam divides each entry's step by the root of its own squared
        # gradient: where a gradient is near zero (a bias whose steps
        # cancel), the gradient's float32 rounding enters the step at full
        # relative size, so the bound is relative to the largest parameter
        scale = max(float(np.abs(np.asarray(r)).max()) for r in ref)
        for g, r, s0, n in zip(got, ref, start, names * 2):
            np.testing.assert_allclose(
                g.detach().numpy(), np.asarray(r), rtol=1e-5,
                atol=1e-5 * scale, err_msg=f"param {n}")
        moved = [float(np.abs(np.asarray(r) - np.asarray(s0)).max())
                 for r, s0 in zip(ref, start)]
        assert min(moved) > 0


def test_ppo_improves():
    cfg = P.PPOConfig()
    sim, pi, v = P.make_train(64, cfg, seed=1, device="cpu")
    gen = P.generator(101, sim.device)
    step_fn = sim.step_fn()
    state = sim.state
    first = None
    for u in range(120):
        state, frames = P.update(step_fn, state, pi, v, gen, cfg,
                                 P.cart_obs)
        if u == 10:
            first = float(P.episode_length(frames))
    last = float(P.episode_length(frames))
    assert np.isfinite(last)
    # a random policy survives ~20 steps; learning should clearly beat it
    assert last > max(40.0, 1.5 * first), (first, last)


def test_reinforce_learns():
    torch.manual_seed(0)
    ep_len = R.main(["--worlds", "64", "--updates", "25", "--horizon", "48",
                     "--device", "cpu"])
    assert ep_len > 40.0           # a random policy is ~10-20


def test_overcooked_ppo_update():
    cfg = P.PPOConfig(horizon=8, ent_coef=0.02, lr=5e-4)
    sim, pi, v, obs_of = PO.make_train(8, cfg, seed=0, device="cpu")
    before = [p.detach().clone() for p in pi.parameters()]
    state, frames = P.update(sim.step_fn(), sim.state, pi, v,
                             P.generator(7, sim.device), cfg, obs_of,
                             keep=("deliveries",))
    assert frames["obs"].shape == (8, 8, 2, 320)
    assert frames["act"].shape == frames["rew"].shape == (8, 8, 2)
    assert all(torch.isfinite(x).all() for x in frames["losses"])
    assert all(torch.isfinite(p).all() for p in pi.parameters())
    assert any(not torch.equal(a, b) for a, b in zip(before,
                                                      pi.parameters()))
    delivered, finished = PO.delivery_stats(frames)
    assert float(finished) == 0.0 and float(delivered) == 0.0
    assert int(state.step) == 8
