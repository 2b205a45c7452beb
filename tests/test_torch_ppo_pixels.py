"""The port's vision PPO (examples/torch_train_ppo_pixels.py) vs the JAX
example's (examples/train_ppo_pixels.py), on weights carried across
(conv_net_from_numpy of init_conv_net's arrays) and a fixed seeded pixel
batch (8 worlds x 4 agents of 16 x 16 RGBD in [0, 1]).

Tolerances (measured on this CPU, then stated):
- the bfloat16 convolutions (SAME padding, bias added in bfloat16) equal
  the JAX package's bit for bit; the float32 logits and value within
  2e-6 of the largest reference entry (seen: 7.5e-8 of 0.19 and 3.3e-6 of
  10.5, one float32 summation order apart);
- logp_entropy within 1e-6 (float32 log-softmax sums);
- gae within 1e-6 relative; the loss within 1e-5 relative; the float32
  trunk's and heads' gradients within 1e-5 of their largest reference
  entry (seen: 6.4e-7). The convolutions' gradients come out of
  bfloat16 backward passes, which the two packages sum in different
  orders: the weights' within 5e-3 and the biases' (sums over 2048
  bfloat16 terms) within 5e-2 of their largest reference entry (seen:
  3.4e-3 and 3.8e-2), and the port's no farther from the float32
  gradient (the same loss with float32 convolutions) than 1.5 times the
  JAX package's is (seen: both 2.5e-2 to 5.5e-2 from it on the biases);
- two Adam epochs with moments and step count carried in (m, v random,
  t = 3, step count then 5): the float32 layers' parameters and moments
  within 1e-5 of their largest reference entry; the convolutions'
  parameters within 5e-5 absolute (a fifth of one step's lr = 2.5e-4;
  seen: 1.8e-5) and their moments within 5e-2 of their largest entry
  (the gradients' bound above).
The JAX closures (gae, loss_fn, the adam scan in make_train) are
restated with jax line for line, as tests/test_torch_learners.py does.
tests/test_train_ppo.py's vision case runs on the port: one update at 2
worlds on each render tier, finite, the parameters moved.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import torch_train_ppo_pixels as TP                       # noqa: E402
from train_ppo_pixels import (                            # noqa: E402
    VPPOConfig, encode, init_conv_net, logp_entropy,
)

torch.set_num_threads(1)

HEADS = (4, 8, 5, 2, 2)
B, S = 32, 16
CFG = VPPOConfig()


@pytest.fixture(scope="module")
def carried():
    p = init_conv_net(jax.random.PRNGKey(0), S, S, 4, HEADS)
    pn = jax.tree_util.tree_map(np.asarray, p)
    rs = np.random.RandomState(0)
    obs = rs.rand(B, S, S, 4).astype(np.float32)
    act = np.stack([rs.randint(0, n, B) for n in HEADS], -1).astype(np.int32)
    return p, pn, obs, act


def _net(pn):
    return TP.conv_net_from_numpy(pn, HEADS, device="cpu")


def _names(pn):
    """(port parameter name, JAX path) pairs in the port's order."""
    return [(k, tuple(k.rsplit("_", 1))) for k in _net(pn).p.keys()]


def test_conv_net_matches_jax_encode(carried):
    p, pn, obs, _ = carried
    ref_lg, ref_v = jax.jit(lambda p, x: encode(p, x, HEADS))(
        p, jnp.asarray(obs))
    net = _net(pn)
    with torch.no_grad():
        got_lg, got_v = net(torch.from_numpy(obs))
    for r, g in zip(ref_lg, got_lg):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 2e-6 * np.abs(r).max()
    r = np.asarray(ref_v)
    assert np.abs(got_v.numpy() - r).max() <= 2e-6 * np.abs(r).max()

    # the convolution features alone: equal bit for bit
    def feats_j(p, x):
        x = x.astype(jnp.bfloat16)
        for i in range(2):
            q = p[f"conv{i}"]
            x = jax.nn.relu(jax.lax.conv_general_dilated(
                x, q["w"].astype(jnp.bfloat16), window_strides=(2, 2),
                padding="SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
                + q["b"].astype(jnp.bfloat16))
        return x

    ref_f = np.asarray(jax.jit(feats_j)(p, jnp.asarray(obs)), np.float32)
    with torch.no_grad():
        x = torch.from_numpy(obs).to(torch.bfloat16).permute(0, 3, 1, 2)
        for i in range(2):
            ph, pw = TP._same_pad(x.shape[2]), TP._same_pad(x.shape[3])
            x = torch.nn.functional.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            x = torch.relu(torch.nn.functional.conv2d(
                x, net.p[f"conv{i}_w"].to(torch.bfloat16).permute(3, 2, 0, 1),
                stride=2) + net.p[f"conv{i}_b"].to(torch.bfloat16)[
                    None, :, None, None])
        got_f = x.permute(0, 2, 3, 1).float().numpy()
    assert got_f.shape == ref_f.shape == (B, 4, 4, 32)
    np.testing.assert_array_equal(got_f, ref_f)
    # "SAME" pads 0 before and 1 after on an even size
    assert TP._same_pad(16) == (0, 1) and TP._same_pad(8) == (0, 1)
    assert TP._same_pad(9) == (1, 1)


def test_logp_entropy_and_sampling(carried):
    rs = np.random.RandomState(1)
    logits = [rs.randn(B, n).astype(np.float32) * 2 for n in HEADS]
    act = carried[3]
    r_lp, r_ent = logp_entropy([jnp.asarray(x) for x in logits],
                               jnp.asarray(act))
    g_lp, g_ent = TP.logp_entropy([torch.from_numpy(x) for x in logits],
                                  torch.from_numpy(act))
    np.testing.assert_allclose(g_lp.numpy(), np.asarray(r_lp), atol=1e-6)
    np.testing.assert_allclose(g_ent.numpy(), np.asarray(r_ent), atol=1e-6)
    # draws lie in their heads' ranges, and their logp is logp_entropy's
    gen = torch.Generator().manual_seed(3)
    a, lp = TP.sample_multi([torch.from_numpy(x) for x in logits], gen)
    assert a.dtype == torch.int32 and a.shape == (B, len(HEADS))
    assert all(int(a[:, j].max()) < n for j, n in enumerate(HEADS))
    assert int(a.min()) >= 0
    torch.testing.assert_close(
        lp, TP.logp_entropy([torch.from_numpy(x) for x in logits], a)[0],
        rtol=0, atol=1e-6)


def _j_gae(rew, done, val, last_val, cfg):
    """make_train's gae closure (train_ppo_pixels.py:165-177)."""
    def back(carry, fr):
        adv_next, v_next = carry
        nd = 1.0 - fr["done"]
        delta = fr["rew"] + cfg.gamma * nd * v_next - fr["val"]
        adv = delta + cfg.gamma * cfg.lam * nd * adv_next
        return (adv, fr["val"]), adv

    (_, _), advs = jax.lax.scan(
        back, (jnp.zeros_like(last_val), last_val),
        dict(rew=rew, done=done, val=val), reverse=True)
    return advs


def _j_loss(p, batch, cfg, encode_fn=encode):
    """make_train's loss_fn (train_ppo_pixels.py:179-191)."""
    logits, v = encode_fn(p, batch["obs"], HEADS)
    lp, ent = logp_entropy(logits, batch["act"])
    ratio = jnp.exp(lp - batch["logp"])
    adv = batch["adv"]
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    pg = -jnp.minimum(
        ratio * adv, jnp.clip(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv,
    ).mean()
    v_loss = jnp.mean((v - batch["ret"]) ** 2)
    return pg + cfg.vf_coef * v_loss - cfg.ent_coef * ent.mean()


def _batch(carried):
    """A fixed batch: the pixels, actions, old log-probs off the current
    policy, and non-constant advantages and returns."""
    _, _, obs, act = carried
    rs = np.random.RandomState(2)
    return dict(obs=obs, act=act,
                logp=(rs.randn(B) * 0.3 - 7.0).astype(np.float32),
                adv=rs.randn(B).astype(np.float32),
                ret=rs.randn(B).astype(np.float32) * 3)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_gae_loss_and_gradients_match_jax(carried):
    p, pn, _, _ = carried
    rs = np.random.RandomState(4)
    t_len = 16
    rew = rs.randn(t_len, B).astype(np.float32)
    done = (rs.rand(t_len, B) < 0.1).astype(np.float32)
    val = rs.randn(t_len, B).astype(np.float32)
    last = rs.randn(B).astype(np.float32)
    ref = np.asarray(_j_gae(*(jnp.asarray(x) for x in (rew, done, val, last)),
                            CFG))
    got = TP.gae(*(torch.from_numpy(x) for x in (rew, done, val, last)),
                 CFG).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)

    batch = _batch(carried)
    r_loss, r_grad = jax.jit(jax.value_and_grad(
        lambda p, b: _j_loss(p, b, CFG)))(p, _jb(batch))
    net = _net(pn)
    loss = TP.ppo_loss(net, _tb(batch), CFG)
    grads = dict(zip(net.p.keys(),
                     torch.autograd.grad(loss, list(net.parameters()))))
    np.testing.assert_allclose(float(loss.detach()), float(r_loss),
                               rtol=1e-5)
    # the same loss with float32 convolutions: the gradient the bfloat16
    # ones approximate
    _, g32 = jax.jit(jax.value_and_grad(
        lambda p, b: _j_loss(p, b, CFG, encode_fn=_encode_f32)))(
            p, _jb(batch))
    worst = {}
    for name, (mod, leaf) in _names(pn):
        r = np.asarray(r_grad[mod][leaf])
        g = grads[name].numpy()
        scale = max(np.abs(r).max(), 1e-30)
        worst[name] = d = np.abs(g - r).max() / scale
        if mod.startswith("conv"):
            assert d <= (5e-2 if leaf == "b" else 5e-3), (name, d)
            f = np.asarray(g32[mod][leaf])
            assert np.abs(g - f).max() <= 1.5 * np.abs(r - f).max(), name
        else:
            assert d <= 1e-5, (name, d)
    print("gradient differences / largest entry:", worst)


def _encode_f32(p, rgbd, n_heads):
    """encode with float32 convolutions (precision HIGHEST)."""
    x = rgbd
    for i in range(2):
        q = p[f"conv{i}"]
        x = jax.nn.relu(jax.lax.conv_general_dilated(
            x, q["w"], window_strides=(2, 2), padding="SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=jax.lax.Precision.HIGHEST) + q["b"])
    x = x.reshape(x.shape[0], -1)
    h = jnp.tanh(x @ p["fc"]["w"] + p["fc"]["b"])
    return ([h @ p[f"pi{j}"]["w"] + p[f"pi{j}"]["b"]
             for j in range(len(n_heads))],
            (h @ p["v"]["w"] + p["v"]["b"])[..., 0])


def _j_adam(p, m, v, t, batch, cfg):
    """make_train's adam scan (train_ppo_pixels.py:214-235)."""
    def adam(carry, i):
        p, m, v, t = carry
        g = jax.grad(lambda p: _j_loss(p, batch, cfg))(p)
        m = jax.tree_util.tree_map(lambda a, b: 0.9 * a + 0.1 * b, m, g)
        v = jax.tree_util.tree_map(
            lambda a, b: 0.999 * a + 0.001 * b * b, v, g)
        t = t + 1.0
        mh = jax.tree_util.tree_map(lambda a: a / (1 - 0.9 ** t), m)
        vh = jax.tree_util.tree_map(lambda a: a / (1 - 0.999 ** t), v)
        p = jax.tree_util.tree_map(
            lambda w, a, b: w - cfg.lr * a / (jnp.sqrt(b) + 1e-8),
            p, mh, vh)
        return (p, m, v, t), None

    (p, m, v, t), _ = jax.lax.scan(adam, (p, m, v, t), None,
                                   length=cfg.epochs)
    return p, m, v, t


def test_adam_epochs_carry_moments_match_jax(carried):
    p, pn, _, _ = carried
    batch = _batch(carried)
    rs = np.random.RandomState(6)
    m0 = jax.tree_util.tree_map(
        lambda a: (rs.randn(*a.shape) * 1e-3).astype(np.float32), pn)
    v0 = jax.tree_util.tree_map(
        lambda a: (rs.rand(*a.shape) * 1e-5).astype(np.float32), pn)
    r_p, r_m, r_v, r_t = jax.jit(lambda *a: _j_adam(*a, CFG))(
        p, m0, v0, jnp.float32(3.0), _jb(batch))
    net = _net(pn)
    opt = TP.adam_init(net)
    names = _names(pn)
    for i, (_, (mod, leaf)) in enumerate(names):
        opt["m"][i].copy_(torch.from_numpy(m0[mod][leaf]))
        opt["v"][i].copy_(torch.from_numpy(v0[mod][leaf]))
    opt["t"].fill_(3.0)
    losses = TP.adam_epochs(net, opt, _tb(batch), CFG)
    assert len(losses) == CFG.epochs and float(opt["t"]) == float(r_t) == 5.0
    for i, (name, (mod, leaf)) in enumerate(names):
        for what, got, ref in (("p", net.p[name], r_p),
                               ("m", opt["m"][i], r_m),
                               ("v", opt["v"][i], r_v)):
            r = np.asarray(ref[mod][leaf])
            d = np.abs(got.detach().numpy() - r).max()
            scale = max(np.abs(r).max(), 1e-30)
            if not mod.startswith("conv"):
                assert d <= 1e-5 * scale, (name, what, d)
            elif what == "p":
                assert d <= 5e-5, (name, what, d)
            else:
                assert d <= 5e-2 * scale, (name, what, d)


@pytest.mark.parametrize("tier", ["dense", "blas"])
def test_one_update_on_each_tier(tier):
    """tests/test_train_ppo.py::test_vision_ppo_hide_seek_update on the
    port: horizon 4, one epoch, 2 worlds."""
    import dataclasses

    cfg = dataclasses.replace(VPPOConfig(), horizon=4, epochs=1)
    sim, step_fn, state, obs, net, obs_of = TP.make_train(
        2, cfg, seed=0, render_size=16, tier=tier, device="cpu")
    assert obs.shape == (8, 16, 16, 4)
    before = [x.detach().clone() for x in net.parameters()]
    opt = TP.adam_init(net)
    gen = TP.generator(1, sim.device)
    state, obs2, frames = TP.update(step_fn, state, obs, net, opt, gen, cfg,
                                    obs_of)
    assert np.isfinite(float(frames["rew"].mean()))
    assert torch.isfinite(torch.stack(frames["losses"])).all()
    moved = sum(float((a.detach() - b).abs().max())
                for a, b in zip(net.parameters(), before))
    assert moved > 0.0
    assert all(torch.isfinite(x).all() for x in net.parameters())
    assert obs2.shape == obs.shape and float(opt["t"]) == 1.0
    assert frames["act"].shape == (4, 8, len(HEADS))
