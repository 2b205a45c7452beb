"""The port's tracing and debug utilities (madrona_tpu_torch/utils/tracing.py,
utils/debug.py) against the JAX package's, on the CPU.

  * a ``HostEventLog`` dump is the JAX format: a JSON list of [event,
    t_ns] pairs, the same events in the same order, at the path
    ``MADRONA_TPU_TRACE_NAME`` names;
  * a CPU profile (``profile_trace``) of one Escape Room step (4 worlds)
    names every node as ``"step.<node>"``, the names of the JAX
    package's named scopes for the same graph, and writes a Chrome trace;
  * ``time_step`` returns the JAX function's keys;
  * ``checked`` raises on ``log(-1)`` naming the op, and on an
    out-of-range ``index_select`` and ``gather`` before they launch;
  * a ``checked`` Escape Room step is bit-identical to the plain one, and
    a NaN put into one body's velocity raises naming the physics node;
  * ``print_tensor``'s numbers (shape, min, max, mean) equal the JAX
    function's on the same array, exactly (the array's mean is exact in
    float32).
"""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.models.base import make_sim as j_make_sim
from madrona_tpu.models.escape_room import EscapeRoom as JEscapeRoom
from madrona_tpu.utils import debug as j_debug
from madrona_tpu.utils import tracing as j_tracing
from madrona_tpu_torch import make_sim
from madrona_tpu_torch.models.escape_room import EscapeRoom
from madrona_tpu_torch.utils import debug, tracing
from madrona_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

W = 4


@pytest.fixture(scope="module")
def er():
    """(port sim, its state after one step, the next step's inputs)."""
    sim = make_sim(EscapeRoom(), num_worlds=W, seed=0, device="cpu")
    acts = EscapeRoom.random_actions(np.random.RandomState(0), 2, W)
    reset = torch.zeros((W,), dtype=torch.int32)
    state, _ = sim.step_fn()(sim.state, {"action": acts[0], "reset": reset})
    return sim, state, {"action": acts[1], "reset": reset}


def test_host_event_log_dump_is_jax_format(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MADRONA_TPU_TRACE_NAME", "run")
    dumps = []
    for mod in (tracing, j_tracing):
        log = mod.HostEventLog()
        log.log("boot")
        with log.span("step"):
            log.log("inside")
        path = log.dump()
        assert path == "run.json"
        with open(path) as f:
            dumps.append(json.load(f))
        os.remove(path)
    port, jax_ = dumps
    assert [e for e, _ in port] == [e for e, _ in jax_] == [
        "boot", "step:start", "inside", "step:end"]
    for d in dumps:
        assert all(isinstance(e, str) and isinstance(t, int) for e, t in d)
        assert [t for _, t in d] == sorted(t for _, t in d)


def test_profile_names_every_node(er, tmp_path):
    sim, state, inp = er
    with tracing.profile_trace(str(tmp_path)) as prof:
        sim.step_fn()(state, inp)
    names = {e.key for e in prof.key_averages()}
    j_sim = j_make_sim(JEscapeRoom(), num_worlds=W, seed=0, donate=False)
    j_scopes = {f"step.{n.name}" for n in j_sim.executor.graphs["step"].nodes}
    t_scopes = {f"step.{n.name}" for n in sim.executor.graphs["step"].nodes}
    assert t_scopes == j_scopes
    assert j_scopes <= names, sorted(j_scopes - names)
    with open(prof.trace_path) as f:
        trace = json.load(f)
    assert {e.get("name") for e in trace["traceEvents"]} >= j_scopes


def test_time_step_has_jax_keys(er):
    sim, state, inp = er
    t = tracing.time_step(sim.step_fn(), state, inp, iters=2, warmup=1)
    j = j_tracing.time_step(lambda s, i: s * 2.0, jnp.ones(3), None,
                            iters=2, warmup=1)
    assert set(t) == set(j) == {"mean_ms", "min_ms", "iters"}
    assert t["iters"] == 2 and 0 < t["min_ms"] <= t["mean_ms"]


def test_checked_names_the_op():
    with pytest.raises(debug.CheckError, match="aten.log"):
        debug.checked(torch.log)(torch.tensor([1.0, -1.0]))
    assert torch.equal(debug.checked(torch.log)(torch.tensor([1.0, 2.0])),
                       torch.log(torch.tensor([1.0, 2.0])))
    x = torch.arange(4.0)
    with pytest.raises(debug.CheckError, match="index_select.*out of range"):
        debug.checked(lambda a, i: a.index_select(0, i))(
            x, torch.tensor([0, 4]))
    with pytest.raises(debug.CheckError, match="gather.*out of range"):
        debug.checked(lambda a, i: torch.gather(a, 0, i))(
            x, torch.tensor([-1]))
    # a NaN made and then masked away reaches no result: no report
    out = debug.checked(lambda a: torch.where(a > 0, torch.log(a), 0.0))(
        torch.tensor([-1.0, 1.0]))
    assert torch.equal(out, torch.tensor([0.0, 0.0]))


def _with_nan_velocity(state, world=1, row=20):
    import dataclasses

    t = state.tables["RigidBody"]
    cols = dict(t.columns)
    vel = dict(cols["Velocity"])
    lin = vel["linear"].clone()
    lin[world, row, 0] = float("nan")
    vel["linear"] = lin
    cols["Velocity"] = vel
    tables = dict(state.tables)
    tables["RigidBody"] = dataclasses.replace(t, columns=cols)
    return dataclasses.replace(state, tables=tables)


def test_checked_step_bit_identical_and_names_node(er):
    sim, state, inp = er
    fn = sim.step_fn()
    s_plain, o_plain = fn(state, inp)
    s_chk, o_chk = debug.checked(fn)(state, inp)
    for k in o_plain:
        assert torch.equal(o_plain[k], o_chk[k]), k
    leaves = tree_leaves(s_chk)
    assert len(leaves) == len(tree_leaves(s_plain))
    for (_, a), (path, b) in zip(tree_leaves(s_plain), leaves):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    with pytest.raises(debug.CheckError, match="step.physics_step"):
        debug.checked(fn)(_with_nan_velocity(state), inp)


def _summary_numbers(line):
    """(shape, [min, max, mean]) of a print_tensor line (the JAX package
    prints the shape as a tuple of 0-d arrays)."""
    m = re.search(r"shape=(.*) min=(\S+) max=(\S+) mean=(\S+)", line)
    shape = [int(d) for d in re.findall(r"(?<![\w=])(\d+)(?=[,)])",
                                          m.group(1))]
    return shape, [float(x) for x in m.groups()[1:]]


def test_print_tensor_numbers_equal_jax(capsys):
    a = (np.arange(24, dtype=np.float32).reshape(2, 3, 4) - 7.0) * 0.5
    debug.print_tensor("x", torch.from_numpy(a))
    j_debug.print_tensor("x", jnp.asarray(a))
    debug.host_print("v={v}", v=torch.tensor([1, 2]))
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    port, jax_ = (ln for ln in lines if ln.startswith("x:"))
    assert _summary_numbers(port) == _summary_numbers(jax_)
    assert "v=[1 2]" in lines
