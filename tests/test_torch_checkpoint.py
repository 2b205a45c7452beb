"""Per-world checkpoints of the PyTorch port vs the JAX package's.

- Masked save and restore (tests/test_checkpoint.py's case: Cartpole, 8
  worlds, seed 0, zero actions; even worlds saved after step 6 and
  restored after step 10): the JAX states at steps 3, 6 and 10 are
  carried into the port, and the port's snapshot, save_worlds and
  restore_worlds equal the JAX package's on them bit for bit, the step
  counter included (it follows the live side); the restored state then
  steps on the port with finite observations.
- The disk round trip on the port (seed 1, 5 steps): every leaf equal,
  and three more steps from the loaded state equal those from the saved
  one bit for bit; a file loaded into a state of another shape raises.
- The files cross both ways (Cartpole and Escape Room, port states made
  on the CPU and handed to the JAX package through numpy): a JAX-saved
  npz loads into the port equal to state_from_numpy of the same state,
  a port-saved npz loads into the JAX package equal to its state, and
  the leaves are in jax.tree_util.tree_flatten's order (shapes and
  dtypes leaf by leaf).
- tests/test_train_resume.py on the port: PPO on Cartpole
  (examples/torch_train_ppo.py, 8 worlds, horizon 4) saved after 2
  updates (the sim state with save_npz, the parameters and the action
  generator's state with save_learner) and resumed in a fresh
  make_train for 2 more equals 4 straight updates bit for bit, in every
  parameter and every leaf of the state.
Every comparison is exact: no tolerance.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.models.base import make_sim as j_make_sim
from madrona_tpu.models.cartpole import Cartpole as JCartpole
from madrona_tpu.utils import checkpoint as j_ckpt
from madrona_tpu_torch import make_sim
from madrona_tpu_torch.interop import state_to_numpy
from madrona_tpu_torch.models.cartpole import Cartpole
from madrona_tpu_torch.models.escape_room import EscapeRoom
from madrona_tpu_torch.utils import checkpoint as ckpt

from torch_port import assert_trees_equal, carry_state, jax_state, jax_tree

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import torch_train_ppo as P    # noqa: E402

torch.set_num_threads(1)

W = 8


def _inputs(w):
    return {"action": torch.zeros((w,), dtype=torch.int32),
            "reset": torch.zeros((w,), dtype=torch.int32)}


def _j_run(step, s, steps):
    for _ in range(steps):
        s, _ = step(s, {"action": jnp.zeros((W,), jnp.int32),
                        "reset": jnp.zeros((W,), jnp.int32)})
    return s


def test_masked_save_restore_matches_jax():
    j_sim = j_make_sim(JCartpole(), num_worlds=W, seed=0, donate=False)
    step = j_sim.step_fn()
    s0 = _j_run(step, j_sim.state, 3)
    s1 = _j_run(step, s0, 3)
    s2 = _j_run(step, s1, 4)
    even = np.arange(W) % 2 == 0
    j_buf = j_ckpt.save_worlds(j_ckpt.snapshot(s0), s1, jnp.asarray(even))
    j_s3 = j_ckpt.restore_worlds(s2, j_buf, jnp.asarray(even))

    t0, t1, t2 = (carry_state(s) for s in (s0, s1, s2))
    buf = ckpt.snapshot(t0)
    assert_trees_equal(state_to_numpy(buf), state_to_numpy(t0))
    buf = ckpt.save_worlds(buf, t1, even.tolist())
    s3 = ckpt.restore_worlds(t2, buf, torch.from_numpy(even))
    assert_trees_equal(state_to_numpy(buf), jax_tree(j_buf))
    assert_trees_equal(state_to_numpy(s3), jax_tree(j_s3))
    # the step counter stays live; the snapshot's tensors are its own
    assert int(s3.step) == int(t2.step) == int(s2.step)
    assert buf.rng.data_ptr() != t0.rng.data_ptr()

    sim = make_sim(Cartpole(), num_worlds=W, seed=0, device="cpu")
    fn = sim.step_fn()
    s4 = s3
    for _ in range(2):
        s4, out = fn(s4, _inputs(W))
    assert torch.isfinite(out["obs"]).all()


def test_disk_roundtrip(tmp_path):
    sim = make_sim(Cartpole(), num_worlds=W, seed=1, device="cpu")
    fn = sim.step_fn()
    s = sim.state
    for _ in range(5):
        s, _ = fn(s, _inputs(W))
    path = os.path.join(tmp_path, "ck.npz")
    ckpt.save_npz(path, s)
    s2 = ckpt.load_npz(path, s)
    assert_trees_equal(state_to_numpy(s2), state_to_numpy(s))
    for _ in range(3):
        s, oa = fn(s, _inputs(W))
        s2, ob = fn(s2, _inputs(W))
        assert torch.equal(oa["obs"], ob["obs"])
    other = make_sim(Cartpole(), num_worlds=4, seed=1, device="cpu").state
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.load_npz(path, other)


@pytest.mark.parametrize("env", ["cartpole", "escape_room"])
def test_npz_crosses_both_ways(env, tmp_path):
    make_env, w = {"cartpole": (Cartpole, W),
                   "escape_room": (EscapeRoom, 4)}[env]
    sim = make_sim(make_env(), num_worlds=w, seed=3, device="cpu")
    inputs = _inputs(w)
    if env == "escape_room":
        inputs["action"] = EscapeRoom.random_actions(
            np.random.RandomState(0), 1, w)[0]
    for _ in range(2):
        sim.step(inputs)
    port = sim.state
    j_st = jax_state(port)
    ref_leaves = jax.tree_util.tree_leaves(j_st)
    got_leaves = ckpt._leaves(state_to_numpy(port))
    assert [(np.shape(a), np.asarray(a).dtype) for a in ref_leaves] == [
        (a.shape, a.dtype) for a in got_leaves]

    j_path = os.path.join(tmp_path, "jax.npz")
    j_ckpt.save_npz(j_path, j_st)
    assert_trees_equal(state_to_numpy(ckpt.load_npz(j_path, port)),
                       state_to_numpy(carry_state(j_st)))

    t_path = os.path.join(tmp_path, "port.npz")
    ckpt.save_npz(t_path, port)
    assert_trees_equal(jax_tree(j_ckpt.load_npz(t_path, j_st)),
                       jax_tree(j_st))


def _train(n_updates, seed=0, resume=None):
    """(sim, state, nets, action generator) after ``n_updates`` PPO
    updates of a fresh make_train, first loading ``resume`` (the paths
    of the sim's and the learner's files) where given."""
    import dataclasses

    cfg = dataclasses.replace(P.PPOConfig(), horizon=4)
    sim, pi, v = P.make_train(W, cfg, seed=seed, device="cpu")
    gen = P.generator(seed + 100, sim.device)
    state = sim.state
    if resume is not None:
        state = ckpt.load_npz(resume[0], state)
        P.load_learner(resume[1], (pi, v), gen)
    fn = sim.step_fn()
    for _ in range(n_updates):
        state, _ = P.update(fn, state, pi, v, gen, cfg, P.cart_obs)
    return sim, state, (pi, v), gen


def test_ppo_resume_is_bit_identical(tmp_path):
    _, st_a, nets_a, _ = _train(4)
    _, st_b, nets_b, gen_b = _train(2)
    paths = (str(tmp_path / "ck.npz"), str(tmp_path / "learner.npz"))
    ckpt.save_npz(paths[0], st_b)
    P.save_learner(paths[1], nets_b, gen_b)
    _, st_c, nets_c, _ = _train(2, resume=paths)
    for na, nc in zip(nets_a, nets_c):
        for a, c in zip(na.parameters(), nc.parameters()):
            assert torch.equal(a, c)
    assert_trees_equal(state_to_numpy(st_c), state_to_numpy(st_a))
