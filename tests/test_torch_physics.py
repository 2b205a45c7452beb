"""Physics of the PyTorch port vs the JAX package's XLA tier, from one
carried-across Escape Room state.

States come from a seeded JAX rollout (random actions) and are carried
into the port with madrona_tpu_torch.interop, one grab joint switched
on so the joint solve is exercised. Tolerances are those of the JAX
package's own kernel goldens (tests/golden_inputs.py:484-492):
  narrowphase: ref/alt/num exact; normals 1e-4; manifold points 1e-3,
    compared without regard to order;
  one physics step: pos/rot 1e-3, vel 5e-2, omega 2e-1."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.models.base import make_sim as j_make_sim
from madrona_tpu.models.escape_room import EscapeRoom as JEscapeRoom
from madrona_tpu.physics import api as japi
from madrona_tpu.physics import broadphase as jbp
from madrona_tpu.physics import xpbd as jxpbd
from madrona_tpu_torch import make_sim
from madrona_tpu_torch.models import escape_room as er
from madrona_tpu_torch.models.escape_room import EscapeRoom
from madrona_tpu_torch.physics import api as tapi
from madrona_tpu_torch.physics import broadphase as tbp
from madrona_tpu_torch.physics import xpbd as txpbd

from torch_port import (
    body_arrays, carry_state, jax_tree, sorted_live_points, torch_body,
)

torch.set_num_threads(1)

W = 8
STEPS_AT = (5, 30)
TOL_NARROW = 1e-4
TOL_PTS = 1e-3
TOL_POS = TOL_ROT = 1e-3
TOL_VEL = 5e-2
TOL_OMEGA = 2e-1


def _with_grab(state):
    """Switch grab joint slot 0 of world 0 on: agent 0 holds cube 0 at
    their current relative pose (both packages get the same buffer)."""
    jb = dict(state.singletons[japi.JOINT_BUFFER])
    set_ = lambda k, v: jb[k].at[0, 0].set(v)   # noqa: E731
    jb.update(
        e1=set_("e1", er.ROW_AGENT0), e2=set_("e2", er.ROW_CUBE0),
        jtype=set_("jtype", 0), separation=set_("separation", 0.0),
        r1=set_("r1", jnp.array([0.0, 0.6, 0.0])),
        r2=set_("r2", jnp.array([0.0, -0.6, 0.0])),
        attach_q1=set_("attach_q1", jnp.array([1.0, 0, 0, 0])),
        attach_q2=set_("attach_q2", jnp.array([1.0, 0, 0, 0])),
        active=set_("active", True),
    )
    singles = dict(state.singletons)
    singles[japi.JOINT_BUFFER] = jb
    return dataclasses.replace(state, singletons=singles)


@pytest.fixture(scope="module")
def world():
    j_sim = j_make_sim(JEscapeRoom(), num_worlds=W, seed=3, donate=False)
    step = j_sim.step_fn()
    acts = np.asarray(JEscapeRoom.random_actions(
        np.random.RandomState(4), max(STEPS_AT), W
    ))
    states = {}
    s = j_sim.state
    for t in range(max(STEPS_AT)):
        s, _ = step(s, {"action": jnp.asarray(acts[t]),
                        "reset": jnp.zeros((W,), jnp.int32)})
        if t + 1 in STEPS_AT:
            states[t + 1] = _with_grab(s)
    t_sim = make_sim(EscapeRoom(), num_worlds=W, seed=3, device="cpu")
    return j_sim, t_sim, states


def _assert_contacts_match(t_c, j_c):
    for f in ("ref", "alt", "num"):
        np.testing.assert_array_equal(getattr(t_c, f).numpy(),
                                      np.asarray(getattr(j_c, f)), err_msg=f)
    num = np.asarray(j_c.num)
    live = num > 0
    d_n = np.abs(t_c.normal.numpy() - np.asarray(j_c.normal))
    assert np.where(live[..., None], d_n, 0.0).max() <= TOL_NARROW
    d_p = np.abs(sorted_live_points(t_c.points.numpy(), num)
                 - sorted_live_points(np.asarray(j_c.points), num))
    assert d_p.max() <= TOL_PTS
    return live


def _contacts(j_sim, t_sim, j_state):
    env_j, env_t = j_sim.env, t_sim.env
    cfg = env_j.cfg
    h = cfg.dt / cfg.substeps
    j_body = japi.body_state(j_sim.executor.sm, j_state)
    j_c = jax.jit(lambda b: japi._narrowphase_all(
        jxpbd.integrate(b, env_j.om, h, cfg.gravity), env_j.om,
        jbp.find_candidates(b, env_j.om, env_j.caps, cfg.dt), sat_dirs=True,
    ))(j_body)
    t_body = tapi.body_state(t_sim.executor.sm, carry_state(j_state))
    t_c = tapi._narrowphase_all(
        txpbd.integrate(t_body, env_t.om, h, cfg.gravity), env_t.om,
        tbp.find_candidates(t_body, env_t.om, env_t.caps, cfg.dt),
    )
    return j_c, t_c


@pytest.mark.parametrize("at", STEPS_AT)
def test_narrowphase_matches_jax(world, at):
    j_sim, t_sim, states = world
    j_c, t_c = _contacts(j_sim, t_sim, states[at])
    assert _assert_contacts_match(t_c, j_c).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_narrowphase_random_boxes_match_jax(seed):
    """Hull-hull and hull-plane lanes on crowded scenes of rotated,
    scaled boxes (the Escape Room rarely has hull-hull contacts)."""
    from madrona_tpu.physics import bodies as jbodies
    from madrona_tpu.physics import geo as jgeo
    from madrona_tpu.physics.xpbd import BodyState as JBody
    from madrona_tpu_torch.physics import bodies as tbodies
    from madrona_tpu_torch.physics import geo as tgeo

    oms = []
    for mod, geo in ((jbodies, jgeo), (tbodies, tgeo)):
        reg = mod.ObjectRegistry()
        reg.add_plane()
        reg.add_hull(geo.box_hull((0.5, 0.5, 0.5)), mass=1.0)
        reg.add_hull(geo.box_hull((0.4, 0.8, 0.3)), mass=2.5)
        oms.append(reg.build())
    j_om, t_om = oms
    arrays = body_arrays(np.random.RandomState(seed), 8, 12, 3,
                         crowded=True)
    caps = (16, 8, 0)
    j_body = JBody(**{k: jnp.asarray(v) for k, v in arrays.items()})
    j_c = jax.jit(lambda b: japi._narrowphase_all(
        b, j_om, jbp.find_candidates(b, j_om, jbp.CandidateCaps(*caps),
                                     0.04), sat_dirs=True,
    ))(j_body)
    t_body = torch_body(arrays)
    t_c = tapi._narrowphase_all(
        t_body, t_om,
        tbp.find_candidates(t_body, t_om, tbp.CandidateCaps(*caps), 0.04),
    )
    live = _assert_contacts_match(t_c, j_c)
    assert live[:, :caps[0]].sum() > 20 and live[:, caps[0]:].any()


@pytest.mark.parametrize("at", STEPS_AT)
def test_physics_step_matches_jax(world, at):
    j_sim, t_sim, states = world
    j_state = states[at]
    env_j, env_t = j_sim.env, t_sim.env
    j_node = japi.make_physics_node(j_sim.executor.sm, env_j.om, env_j.cfg,
                                    env_j.caps)
    j_out = jax.jit(lambda s: j_node(j_sim.executor.sm, s, None))(j_state)
    t_node = tapi.make_physics_node(t_sim.executor.sm, env_t.om, env_t.cfg,
                                    env_t.caps)
    t_out = t_node(t_sim.executor.sm, carry_state(j_state), None)

    jc = jax_tree(j_out.tables[er.RIGID_BODY].columns)
    tc = t_out.tables[er.RIGID_BODY].columns
    for name, got, ref, tol in (
        ("pos", tc["Position"], jc["Position"], TOL_POS),
        ("rot", tc["Rotation"], jc["Rotation"], TOL_ROT),
        ("vel", tc["Velocity"]["linear"], jc["Velocity"]["linear"], TOL_VEL),
        ("omega", tc["Velocity"]["angular"], jc["Velocity"]["angular"],
         TOL_OMEGA),
    ):
        d = np.abs(got.numpy().astype(np.float64) - ref).max()
        assert d <= tol, (name, d)
    # the step moved something
    moved = np.abs(jc["Position"] - jax_tree(
        j_state.tables[er.RIGID_BODY].columns)["Position"]).max()
    assert moved > 0.0
