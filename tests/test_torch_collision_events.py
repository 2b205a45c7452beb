"""The CollisionEvents export of the PyTorch port against the JAX package.

Mirrors tests/test_collision_events.py: a plane and a box dropped from
z = 1.2 in each of 2 worlds, made through both packages' entity stores
so the event handles are real Entities. The JAX sim (narrowphase_once,
the XLA tier) runs 60 steps; at each step its state is carried into the
port and one port step is taken from it, on the "xla" tier and on
"kernel_sublane" with megakernel=True (on the CPU every wrapper runs its
plain version). Every integer of the singleton (a, b, row_a, row_b, num,
overflow) must equal the JAX package's bit for bit: the events come
from the contacts computed before the solver, which the JAX package's
record kernel gives bit for bit as its XLA tier does. The same holds
on chip_smoke.py's events scene (four pairs of boxes pressed together on
a plane, 4 worlds, 2 event slots), where events come from hull-hull and
hull-plane lanes, several a world, and the clamp and overflow flag
fire: the JAX sim (XLA tier, jitted) runs 60 steps and one port step on
the scene's own tiers (broadphase "pallas", narrowphase
"kernel_sublane", megakernel) is taken from each carried state, every
integer equal. Then the JAX test's behaviours on the port alone, and the
ValueError of each tier the JAX package refuses (naming
"CollisionEvents")."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.core.registry import ECSRegistry as JRegistry
from madrona_tpu.core.state import StateManager as JStateManager
from madrona_tpu.graph.builder import TaskGraphBuilder as JBuilder
from madrona_tpu.graph.executor import Executor as JExecutor
from madrona_tpu.physics import api as japi
from madrona_tpu.physics.bodies import ObjectRegistry as JObjects
from madrona_tpu.physics.geo import box_hull as j_box_hull
from madrona_tpu.physics.xpbd import PhysicsConfig as JConfig
from madrona_tpu_torch.core.registry import ECSRegistry
from madrona_tpu_torch.core.state import StateManager
from madrona_tpu_torch.graph.builder import TaskGraphBuilder
from madrona_tpu_torch.graph.executor import Executor
from madrona_tpu_torch.physics import api as tapi
from madrona_tpu_torch.physics.bodies import ObjectRegistry
from madrona_tpu_torch.physics.broadphase import CandidateCaps
from madrona_tpu_torch.physics.geo import box_hull
from madrona_tpu_torch.physics.xpbd import PhysicsConfig

import chip_smoke
from torch_port import carry_state, events_scene_jax

torch.set_num_threads(1)

W = 2
STEPS = 60
FIELDS = ("a", "b", "row_a", "row_b", "num", "overflow")
TIERS = {
    "xla": {},
    "kernel_sublane_megakernel": dict(narrowphase="kernel_sublane",
                                      megakernel=True),
}


def _values(asarray):
    """The component values of the two rows: a static plane and a
    dynamic box at z = 1.2."""
    pos = np.zeros((W, 2, 3), np.float32)
    pos[:, 1] = [0, 0, 1.2]
    rot = np.zeros((W, 2, 4), np.float32)
    rot[..., 0] = 1
    z3 = asarray(np.zeros((W, 2, 3), np.float32))
    return {
        "Position": asarray(pos), "Rotation": asarray(rot),
        "Scale": asarray(np.ones((W, 2, 3), np.float32)),
        "ObjectID": asarray(np.tile([1, 0], (W, 1)).astype(np.int32)),
        "ResponseType": asarray(np.tile([2, 0], (W, 1)).astype(np.int32)),
        "Velocity": {"linear": z3, "angular": z3},
        "ExternalForce": z3, "ExternalTorque": z3,
        "SubstepPrev": {"x": z3, "q": asarray(rot)},
        "PreSolvePositional": {"x": z3, "q": asarray(rot)},
        "PreSolveVelocity": {"v": z3, "omega": z3},
    }


def build_port(cfg, max_events=4, caps=None):
    """(executor, state manager, object manager, entity handles) of the
    port's scene on the CPU."""
    sm = StateManager()
    reg = ECSRegistry(sm)
    tapi.register_types(reg, max_bodies=4)
    tapi.register_collision_events(reg, max_events=max_events)
    reg.export_singleton(tapi.COLLISION_EVENTS, "events")
    om_r = ObjectRegistry()
    om_r.add_hull(box_hull((0.5, 0.5, 0.5)), mass=1.0)
    om_r.add_plane()
    om = om_r.build()
    b = TaskGraphBuilder(sm, "step")
    tapi.setup_physics_step_tasks(b, om, cfg, caps)
    ex = Executor(sm, {"step": b.build()}, num_worlds=W, seed=0,
                  device="cpu")
    values = _values(torch.from_numpy)
    ex.state, ents = sm.make_entities(ex.state, tapi.RIGID_BODY, values,
                                      torch.ones((W, 2), dtype=torch.bool))
    return ex, sm, om, ents.numpy()


@pytest.fixture(scope="module")
def jax_run():
    """The JAX sim's state before each of 60 steps and its events after."""
    sm = JStateManager()
    reg = JRegistry(sm)
    japi.register_types(reg, max_bodies=4)
    japi.register_collision_events(reg, max_events=4)
    reg.export_singleton(japi.COLLISION_EVENTS, "events")
    om_r = JObjects()
    om_r.add_hull(j_box_hull((0.5, 0.5, 0.5)), mass=1.0)
    om_r.add_plane()
    om = om_r.build()
    b = JBuilder(sm, "step")
    japi.setup_physics_step_tasks(b, om, JConfig(narrowphase_once=True))
    ex = JExecutor(sm, {"step": b.build()}, num_worlds=W, seed=0,
                   donate=False)
    state, _ = sm.make_entities(
        ex.state, japi.RIGID_BODY, _values(jnp.asarray),
        jnp.ones((W, 2), bool))
    step = jax.jit(ex.step_fn())
    states, events = [], []
    for _ in range(STEPS):
        states.append(state)
        state, out = step(state, {})
        events.append({k: np.asarray(v) for k, v in out["events"].items()})
    return states, events


@pytest.mark.parametrize("tier", list(TIERS))
def test_events_match_jax(jax_run, tier):
    """One port step from the carried JAX state at each of 60 steps:
    every integer of the singleton equal."""
    states, events = jax_run
    ex, _, _, _ = build_port(PhysicsConfig(narrowphase_once=True,
                                           **TIERS[tier]))
    step = ex.step_fn()
    fired = 0
    for t, (j_state, j_ev) in enumerate(zip(states, events)):
        _, out = step(carry_state(j_state), {})
        for f in FIELDS:
            got = out["events"][f].numpy()
            assert got.dtype == j_ev[f].dtype, (t, f)
            np.testing.assert_array_equal(got, j_ev[f], err_msg=f"{t} {f}")
        fired += int((j_ev["num"] > 0).any())
    assert fired > 10            # the box reached the plane and stayed


def test_events_scene_matches_jax():
    """chip_smoke's events scene at 4 worlds with 2 event slots: one port
    step from the carried JAX state at each of 60 steps, every integer of
    the singleton equal; the run holds hull-hull events, worlds with
    both slots filled and clamped worlds."""
    w, k = 4, 2
    j_ex, j_ents = events_scene_jax(w, k)
    ex, _, _, ents = chip_smoke.events_scene(w, "cpu", max_events=k)
    np.testing.assert_array_equal(ents.numpy(), j_ents)
    j_step, step = jax.jit(j_ex.step_fn()), ex.step_fn()
    j_state = j_ex.state
    hull_hull = full = clamped = 0
    for t in range(STEPS):
        _, out = step(carry_state(j_state), {})
        j_state, j_out = j_step(j_state, {})
        j_ev = {f: np.asarray(v) for f, v in j_out["events"].items()}
        for f in FIELDS:
            got = out["events"][f].numpy()
            assert got.dtype == j_ev[f].dtype, (t, f)
            np.testing.assert_array_equal(got, j_ev[f], err_msg=f"{t} {f}")
        live = np.arange(k) < j_ev["num"][:, None]
        hull_hull += int((live & (j_ev["row_a"] > 0)
                          & (j_ev["row_b"] > 0)).sum())  # row 0: the plane
        full += int((j_ev["num"] == k).sum())
        clamped += int(j_ev["overflow"].sum())
    assert hull_hull > 50 and full > 50 and clamped > 50, (
        hull_hull, full, clamped)


@pytest.mark.parametrize("tier", ["xla", "megakernel"])
def test_events_fire_on_contact(tier):
    """tests/test_collision_events.py::test_events_fire_on_contact and
    ::test_events_with_megakernel_tier on the port: while the box touches
    the plane each world holds one event, (box, plane) with the spawned
    entities' handles; otherwise the buffer is cleared."""
    change = {"megakernel": True} if tier == "megakernel" else {}
    ex, _, _, ents = build_port(PhysicsConfig(narrowphase_once=True,
                                              **change))
    saw = np.zeros((W,), bool)
    for t in range(STEPS):
        ev = {k: v.numpy() for k, v in ex.run(inputs={})["events"].items()}
        assert (ev["overflow"] == 0).all()
        for w in range(W):
            if ev["num"][w] == 0:
                assert (ev["row_a"][w] == -1).all()
                continue
            saw[w] = True
            assert ev["num"][w] == 1, (t, w)
            assert sorted([ev["row_a"][w, 0], ev["row_b"][w, 0]]) == [0, 1]
            assert ({tuple(ev["a"][w, 0]), tuple(ev["b"][w, 0])}
                    == {tuple(ents[w, 0]), tuple(ents[w, 1])})
            assert (ev["row_a"][w, 1:] == -1).all()
            assert (ev["a"][w, 1:] == -1).all()
    assert saw.all(), "the box never touched the plane in 60 steps"


def test_events_empty_before_contact():
    ex, _, _, _ = build_port(PhysicsConfig(narrowphase_once=True))
    ev = ex.run(inputs={})["events"]
    assert (ev["num"] == 0).all() and (ev["row_a"] == -1).all()
    assert (ev["a"] == -1).all() and (ev["overflow"] == 0).all()


@pytest.mark.parametrize("change", [
    dict(megakernel_fused=True),
    dict(narrowphase_once=False),
    dict(narrowphase="pallas_mega", megakernel=True),
])
def test_events_reject_tiers(change):
    """Where the JAX package raises (megakernel_fused, a narrowphase per
    substep, the contacts kernel tier; TGS in test_torch_tgs.py), the
    port raises ValueError naming CollisionEvents when the node is
    built."""
    cfg = dataclasses.replace(PhysicsConfig(narrowphase_once=True), **change)
    with pytest.raises(ValueError, match="CollisionEvents"):
        build_port(cfg, caps=CandidateCaps(sphere_any=0))
