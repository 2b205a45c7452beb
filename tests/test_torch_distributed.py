"""World sharding and the multi-process runtime of the port
(madrona_tpu_torch/parallel, examples/torch_train_ppo_distributed.py), on
the CPU.

  * ``shard_state`` of a Cartpole and an Escape Room sim (8 worlds) as 2
    and as 4 shards: the shards stepped in turn (their own slices of the
    actions) join into the unsharded sim's state and exports, bit for
    bit, at every one of 4 steps;
  * Cartpole's sharded obs equal the JAX package's sharded step on its
    8-device virtual mesh (tests/test_distributed.py's case) within
    2e-6, tests/test_torch_cartpole.py's bound for the unsharded step
    (XLA contracts a*b+c into an FMA on the CPU, eager PyTorch does
    not);
  * a shard of a count that does not divide raises, as JAX's
    ``worlds_per_host`` does;
  * a 2-process gloo worker, started as subprocesses as in
    tests/test_multiprocess.py: ``initialize``, ``worlds_per_host`` (8 ->
    4, 7 raises), ``weak_scaling`` at counts [1, 2], the all-reduced PPO
    gradient of each rank's half of a batch against the one-process
    gradient of the whole batch (within 1e-6, absolute), and one
    training update leaving the parameters equal on both ranks;
  * ``torch_train_ppo_distributed.main(["--worlds", "256", "--updates",
    "25", "--cpu-procs", "2"])`` clears
    tests/test_train_ppo.py::test_ppo_distributed_8dev_mesh's bar
    (episode length > 25) with the parameters identical on both ranks.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.models.base import make_sim as j_make_sim
from madrona_tpu.models.cartpole import Cartpole as JCartpole
from madrona_tpu.parallel import distributed as j_dist
from madrona_tpu.parallel import mesh as j_mesh
from madrona_tpu_torch import make_sim
from madrona_tpu_torch.models.cartpole import Cartpole
from madrona_tpu_torch.models.escape_room import EscapeRoom
from madrona_tpu_torch.parallel import mesh as pmesh
from madrona_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
W = 8
STEPS = 4


def _leaves(tree):
    return [t for _, t in tree_leaves(tree)]


def _assert_trees_equal(a, b, what):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: leaf {i}"


@pytest.mark.parametrize("env_cls", [Cartpole, EscapeRoom],
                         ids=["cartpole", "escape_room"])
def test_shards_stepped_in_turn_equal_unsharded(env_cls):
    sim = make_sim(env_cls(), num_worlds=W, seed=0, device="cpu")
    acts = env_cls.random_actions(np.random.RandomState(1), STEPS, W)
    reset = torch.zeros((W,), dtype=torch.int32)
    fn = sim.step_fn()
    spec = pmesh.state_shardings(sim.state)
    assert spec.step is None and spec.rng == pmesh.WORLD_AXIS
    for n in (2, 4):
        full = sim.state
        shards = [pmesh.shard_state(full, pmesh.Mesh(r, n, CPU))
                  for r in range(n)]
        for t in range(STEPS):
            full, f_out = fn(full, {"action": acts[t], "reset": reset})
            outs = []
            for r in range(n):
                inp = pmesh.shard_inputs({"action": acts[t], "reset": reset},
                                         W, pmesh.Mesh(r, n, CPU))
                shards[r], o = fn(shards[r], inp)
                outs.append(o)
            _assert_trees_equal(pmesh.join_shards(shards, W // n), full,
                                f"{n} shards, state after step {t}")
            _assert_trees_equal(pmesh.join_shards(outs, W // n), f_out,
                                f"{n} shards, exports of step {t}")


def test_cartpole_shards_match_jax_mesh():
    """The port's 8 shards against tests/test_distributed.py's sharded
    step on the JAX package's 8-device CPU mesh."""
    w = 16
    j_sim = j_make_sim(JCartpole(), num_worlds=w, seed=0, donate=False)
    j_step = j_sim.step_fn()
    mesh = j_dist.global_mesh()
    assert mesh.devices.size == 8
    acts = Cartpole.random_actions(np.random.RandomState(2), STEPS, w)
    j_state = j_mesh.shard_state(j_sim.state, mesh)
    sim = make_sim(Cartpole(), num_worlds=w, seed=0, device="cpu")
    fn = sim.step_fn()
    shards = [pmesh.shard_state(sim.state, pmesh.Mesh(r, 8, CPU))
              for r in range(8)]
    for t in range(STEPS):
        inp = {"action": jnp.asarray(acts[t].numpy()),
               "reset": jnp.zeros((w,), jnp.int32)}
        j_state, j_out = j_step(
            j_state, jax.device_put(inp, j_mesh.input_shardings(inp, mesh)))
        assert len(j_out["obs"].sharding.device_set) == 8
        obs = []
        for r in range(8):
            t_inp = pmesh.shard_inputs(
                {"action": acts[t], "reset": torch.zeros((w,),
                                                         dtype=torch.int32)},
                w, pmesh.Mesh(r, 8, CPU))
            shards[r], o = fn(shards[r], t_inp)
            obs.append(o["obs"])
        np.testing.assert_allclose(torch.cat(obs).numpy(),
                                   np.asarray(j_out["obs"]), rtol=0,
                                   atol=2e-6)


def test_uneven_shards_raise():
    sim = make_sim(Cartpole(), num_worlds=W, seed=0, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.shard_state(sim.state, pmesh.Mesh(0, 3, CPU))
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.shard_inputs({"a": torch.zeros(7)}, 7, pmesh.Mesh(1, 2, CPU))


_WORKER = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
repo = os.environ["MTPU_REPO"]
sys.path.insert(0, repo)
sys.path.insert(0, os.path.join(repo, "examples"))
from madrona_tpu_torch import make_sim
from madrona_tpu_torch.models.cartpole import Cartpole
from madrona_tpu_torch.parallel import distributed as pdist
from madrona_tpu_torch.parallel import mesh as pmesh
import torch_train_ppo as tpp
import torch_train_ppo_distributed as tpd

rank = int(os.environ["MTPU_PROC"])
pdist.initialize(os.environ["MTPU_COORD"], 2, rank, device="cpu")
assert pdist.process_count() == 2
assert pdist.worlds_per_host(8) == 4
try:
    pdist.worlds_per_host(7)
    raise SystemExit("expected ValueError")
except ValueError:
    pass
mesh = pdist.global_mesh("cpu")
assert tuple(mesh) == (rank, 2, torch.device("cpu")), mesh

def make_step(w, m):
    sim = make_sim(Cartpole(), num_worlds=w, seed=0, device="cpu")
    pmesh.shard_sim(sim, m)
    n = sim.executor.num_worlds
    inp = {"action": torch.zeros((n,), dtype=torch.int32),
           "reset": torch.zeros((n,), dtype=torch.int32)}
    raw = sim.step_fn()
    return sim.state, inp, lambda s, i: raw(s, i)[0]

res = pdist.weak_scaling(make_step, worlds_per_device=4,
                         device_counts=[1, 2, 4], steps=5, device="cpu")
if rank == 0:
    assert set(res["steps_per_sec"]) == {1, 2}, res
    assert all(v > 0 for v in res["steps_per_sec"].values())
    assert res["efficiency"][1] == 1.0
else:
    assert res is None

# the all-reduced gradient of the shards against the whole batch's
cfg = tpp.PPOConfig()
_, pi, v = tpp.make_train(8, cfg, 0, "cpu")
rs = np.random.RandomState(0)
T, Wb = 6, 16
full = {"obs": torch.from_numpy(rs.randn(T, Wb, 4).astype(np.float32)),
        "act": torch.from_numpy(rs.randint(0, 2, (T, Wb))),
        "logp": torch.from_numpy(np.log(rs.uniform(0.3, 0.7, (T, Wb)))
                                 .astype(np.float32)),
        "adv": torch.from_numpy(rs.randn(T, Wb).astype(np.float32)),
        "ret": torch.from_numpy(rs.randn(T, Wb).astype(np.float32))}
half = {k: x[:, rank * 8:(rank + 1) * 8] for k, x in full.items()}
loss_f, g_full = tpp.loss_grads(pi, v, full, cfg)
_, g_half = tpp.loss_grads(pi, v, half, cfg, tpd.allreduce_mean)
err = max(float((a - b).abs().max()) for a, b in zip(g_full, g_half))
scale = max(float(a.abs().max()) for a in g_full)

# one training update: the parameters stay equal on both ranks
class Args:
    worlds, updates, seed = 16, 1, 0
_, pi2, v2 = tpd.train(Args, mesh, log=lambda *a: None)
same = tpd.params_equal_across_ranks([pi2, v2])
print("RESULT " + json.dumps({"rank": rank, "grad_err": err,
                              "grad_scale": scale, "same": same}),
      flush=True)
torch.distributed.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_worker(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ)
    env.update({"MTPU_COORD": f"127.0.0.1:{_free_port()}",
                "MTPU_REPO": REPO})
    procs = []
    for pid in range(2):
        e = dict(env, MTPU_PROC=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, str(worker)], env=e, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    results = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, out[-3000:]
        results.append(json.loads(line[-1][len("RESULT "):]))
    for r in results:
        assert r["grad_err"] <= 1e-6, r
        assert r["grad_scale"] > 1e-3, r       # a gradient worth comparing
        assert r["same"], r


def test_distributed_ppo_example_learns():
    sys.path.insert(0, os.path.join(REPO, "examples"))
    import torch_train_ppo_distributed as tpd

    ep_len, pi = tpd.main(["--worlds", "256", "--updates", "25",
                           "--cpu-procs", "2"])
    assert ep_len > 25.0          # a random policy's is about 10-15
    assert all(torch.isfinite(p).all() for p in pi.parameters())
