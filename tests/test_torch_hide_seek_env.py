"""Hide & Seek of the PyTorch port on its CPU path, alone.

Determinism across fresh sims bit for bit, pixels included; the two
launches (("step", "render") advances the step counter by two, ("step",)
skips the render); the device default for every render tier;
and the behaviours of tests/test_hide_seek.py at 2 worlds: visibility and
occlusion (a ramp occludes too), seekers frozen in the prep phase, a
locked box stays put, team-owned locks, a ramp is climbable; and a grab
joint that holds. Parity with the JAX package is in
tests/test_torch_hide_seek.py."""

import dataclasses

import numpy as np
import pytest
import torch

from madrona_tpu_torch import make_sim
from madrona_tpu_torch.models import hide_seek as hs
from madrona_tpu_torch.models.hide_seek import HideSeek
from madrona_tpu_torch.physics import api as tapi

torch.set_num_threads(1)

W = 4
SEED = 7


def _t_inputs(act, w=W):
    return {"action": act, "reset": torch.zeros((w,), dtype=torch.int32)}


def _cols(state):
    return state.tables[hs.RIGID_BODY].columns


def test_determinism_across_fresh_sims_pixels_included():
    acts = HideSeek.random_actions(np.random.RandomState(0), 4, W)
    sims = [make_sim(HideSeek(render_size=16), num_worlds=W, seed=SEED,
                     device="cpu") for _ in range(2)]
    for t in range(4):
        o1, o2 = (s.step(_t_inputs(acts[t])) for s in sims)
        assert set(o1) >= {"rgb", "depth", "visible", "flat_obs"}
        for k in o1:
            assert torch.equal(o1[k], o2[k]), (t, k)
    # two graphs per launch: the step counter advances by two
    assert int(sims[0].state.step) == 8
    assert o1["rgb"].shape == (W, hs.N_AGENTS, 16, 16, 3)


def test_state_only_launch_skips_the_render_graph():
    sim = make_sim(HideSeek(render_size=16), num_worlds=2, seed=1,
                   device="cpu")
    out = sim.step(_t_inputs(torch.zeros((2, hs.N_AGENTS, 5),
                                         dtype=torch.int32), 2),
                   launch=("step",))
    assert int(sim.state.step) == 1
    assert float(out["rgb"].abs().max()) == 0.0      # never rendered
    out = sim.step(launch=("render",))
    assert float(out["rgb"].abs().max()) > 0.0
    assert sim.env.default_launch == ("step", "render")
    assert HideSeek(pixels=False).default_launch == ("step",)


def test_make_sim_defaults_to_cuda_and_unported_tiers_raise():
    """make_sim without a device means the card, for every render tier
    (the BLAS tier and the cull tier build since they were ported); the
    4-wide BVH collapse attaches to the BLAS tier's tables (ported too);
    an unknown render tier raises."""
    for env in (HideSeek, lambda: HideSeek(render_tier="blas"),
                lambda: HideSeek(tlas_max_instances=8)):
        if torch.cuda.is_available():
            assert make_sim(env(), num_worlds=2).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError):
                make_sim(env(), num_worlds=2)
    from madrona_tpu_torch.render import blas as t_blas

    blas = HideSeek(render_tier="blas").rsys.blas
    assert blas.wide is None and t_blas.with_wide(blas).wide is not None
    with pytest.raises(ValueError):
        HideSeek(render_tier="nope")


W2 = 2


@pytest.fixture(scope="module")
def sim2():
    return make_sim(HideSeek(pixels=False), num_worlds=W2, seed=5,
                    device="cpu")


def _acts2(**cols):
    """[W2, A, 5] actions: {(agent, column): value}."""
    a = torch.zeros((W2, hs.N_AGENTS, 5), dtype=torch.int32)
    for (agent, col), v in cols.get("set", {}).items():
        a[:, agent, col] = v
    return _t_inputs(a, W2)


def _placed(state, coords, yaws=None, past_prep=True):
    """coords: {row: (x, y)}; yaws: {agent: yaw}."""
    c = dict(_cols(state))
    pos, rot = c["Position"].clone(), c["Rotation"].clone()
    for row, (x, y) in coords.items():
        z = (hs.AGENT_Z if row >= hs.ROW_AGENT0
             else 0.0 if row >= hs.ROW_RAMP0 else hs.BOX_HALF)
        pos[:, row] = torch.tensor([x, y, z])
    for a, yaw in (yaws or {}).items():
        rot[:, hs.ROW_AGENT0 + a] = torch.tensor(
            [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)], dtype=torch.float32)
    c.update(Position=pos, Rotation=rot)
    tables = dict(state.tables)
    tables[hs.RIGID_BODY] = dataclasses.replace(
        state.tables[hs.RIGID_BODY], columns=c)
    singles = dict(state.singletons)
    if past_prep:
        singles["EpisodeStep"] = torch.full((W2,), hs.PREP_STEPS + 1,
                                            dtype=torch.int32)
    return dataclasses.replace(state, tables=tables, singletons=singles)


SPREAD = {
    hs.ROW_BOX0: (10.0, 10.0), hs.ROW_BOX0 + 1: (-10.0, 10.0),
    hs.ROW_BOX0 + 2: (-10.0, -10.0), hs.ROW_RAMP0: (14.0, 0.0),
    hs.ROW_RAMP0 + 1: (-14.0, 0.0), hs.ROW_AGENT0: (0.0, 8.0),
    hs.ROW_AGENT0 + 1: (15.0, -15.0), hs.ROW_AGENT0 + 2: (0.0, 0.0),
    hs.ROW_AGENT0 + 3: (-15.0, -15.0),
}


def test_visibility_and_occlusion(sim2):
    step = sim2.step_fn()
    s, _ = step(sim2.state, _acts2())
    # seeker 0 at the origin facing +y, hider 0 straight ahead
    s = _placed(s, SPREAD, yaws={hs.N_HIDERS: 0.0})
    _, o = step(s, _acts2())
    assert bool((o["visible"][:, 0, 0] == 1).all())
    assert bool((o["reward"][:, hs.N_HIDERS:] > 0).all())
    assert bool((o["reward"][:, 0] < 0).all())
    # a box between them occludes
    _, o = step(_placed(s, {hs.ROW_BOX0: (0.0, 4.0)}), _acts2())
    assert bool((o["visible"][:, 0, 0] == 0).all())
    # a ramp's high end between them occludes too (the wedge mesh in the
    # line-of-sight trace): at local x = -1 the slope stands 0.92 high
    _, o = step(_placed(s, {hs.ROW_RAMP0: (1.0, 4.0)}), _acts2())
    assert bool((o["visible"][:, 0, 0] == 0).all())
    # facing away: out of the cone
    _, o = step(_placed(s, {}, yaws={hs.N_HIDERS: np.pi}), _acts2())
    assert bool((o["visible"][:, 0, 0] == 0).all())


def test_prep_phase_freezes_seekers(sim2):
    step = sim2.step_fn()
    s, _ = step(sim2.state, _acts2())
    move = _acts2(set={(a, 0): 3 for a in range(hs.N_AGENTS)})
    pos0 = _cols(s)["Position"][:, hs.ROW_AGENT0:].clone()
    for _ in range(5):
        s, o = step(s, move)
    moved = (_cols(s)["Position"][:, hs.ROW_AGENT0:, :2]
             - pos0[..., :2]).norm(dim=-1)
    assert bool((moved[:, :hs.N_HIDERS] > 0.2).all())       # hiders move
    assert bool((moved[:, hs.N_HIDERS:] < 1e-3).all())      # seekers frozen
    assert bool((o["reward"] == 0).all())                   # none in prep


LOCK_SCENE = {
    **SPREAD, hs.ROW_AGENT0: (0.0, 0.0), hs.ROW_BOX0: (0.0, 1.6),
    hs.ROW_AGENT0 + 1: (15.0, 15.0), hs.ROW_AGENT0 + 2: (-15.0, -15.0),
    hs.ROW_AGENT0 + 3: (-15.0, 15.0),
}


def test_lock_makes_box_static(sim2):
    step = sim2.step_fn()
    s, _ = step(sim2.state, _acts2())
    s = _placed(s, LOCK_SCENE, yaws={0: 0.0})
    s, _ = step(s, _acts2(set={(0, 4): 1}))
    assert bool((s.singletons["Locked"][:, 0] == 1).all())
    assert bool((_cols(s)["ResponseType"][:, hs.ROW_BOX0] == 2).all())
    box0 = _cols(s)["Position"][:, hs.ROW_BOX0].clone()
    for _ in range(8):                       # push it: it must not move
        s, _ = step(s, _acts2(set={(0, 0): 3}))
    np.testing.assert_allclose(_cols(s)["Position"][:, hs.ROW_BOX0].numpy(),
                               box0.numpy(), atol=1e-5)


def test_team_owned_locks(sim2):
    """A seeker cannot unlock a hider-locked box; the hider can."""
    step = sim2.step_fn()
    s, _ = step(sim2.state, _acts2())
    seeker = hs.N_HIDERS
    s = _placed(s, {**LOCK_SCENE, hs.ROW_AGENT0 + seeker: (0.0, 3.2)},
                yaws={0: 0.0, seeker: np.pi})
    hider_locks = _acts2(set={(0, 4): 1})
    seeker_locks = _acts2(set={(seeker, 4): 1})
    for act, want in ((hider_locks, 1), (seeker_locks, 1), (hider_locks, 0),
                      (seeker_locks, 2)):
        s, _ = step(s, act)
        assert bool((s.singletons["Locked"][:, 0] == want).all()), want
    assert bool((_cols(s)["ResponseType"][:, hs.ROW_BOX0] == 2).all())


def test_grab_joint_holds(sim2):
    """A grabbed box follows its holder; releasing frees the slot."""
    step = sim2.step_fn()
    s, _ = step(sim2.state, _acts2())
    s = _placed(s, LOCK_SCENE, yaws={0: 0.0})
    s, _ = step(s, _acts2(set={(0, 3): 1}))
    assert bool((s.singletons["Grabbed"][:, 0] == hs.ROW_BOX0).all())
    jb = s.singletons[tapi.JOINT_BUFFER]
    assert bool(jb["active"][:, 0].all()) and not bool(jb["active"][:, 1:].any())
    assert bool((jb["e1"][:, 1:] == -1).all())
    # walk backwards (move angle 4 = 180 degrees) holding it
    pull = _acts2(set={(0, 3): 1, (0, 0): 3, (0, 1): 4})
    for _ in range(10):
        s, _ = step(s, pull)
    p = _cols(s)["Position"]
    agent, box = p[:, hs.ROW_AGENT0], p[:, hs.ROW_BOX0]
    assert bool((agent[:, 1] < -0.5).all())               # the agent moved
    gap = (box[:, :2] - agent[:, :2]).norm(dim=-1)
    assert bool(((gap - 1.6).abs() < 0.3).all())          # the box came along
    s, _ = step(s, _acts2())
    assert bool((s.singletons["Grabbed"][:, 0] == -1).all())
    assert not bool(s.singletons[tapi.JOINT_BUFFER]["active"].any())


def test_ramp_is_climbable(sim2):
    """Driving into a ramp's slope raises the agent (the wedge hull in
    the contacts' plain path)."""
    step = sim2.step_fn()
    s, _ = step(sim2.state, _acts2())
    far = {r: (15.0, 15.0 - r) for r in (
        hs.ROW_RAMP0 + 1, hs.ROW_BOX0, hs.ROW_BOX0 + 1, hs.ROW_BOX0 + 2,
        hs.ROW_AGENT0 + 1, hs.ROW_AGENT0 + 2, hs.ROW_AGENT0 + 3)}
    # the slope's low edge is its +x side: approach from +x, facing -x
    s = _placed(s, {**far, hs.ROW_RAMP0: (0.0, 0.0),
                    hs.ROW_AGENT0: (2.5, 0.0)}, yaws={0: np.pi / 2})
    max_z = 0.0
    for _ in range(30):
        s, _ = step(s, _acts2(set={(0, 0): 3}))
        max_z = max(max_z, float(_cols(s)["Position"][0, hs.ROW_AGENT0, 2]))
    assert max_z > hs.AGENT_Z + 0.25, max_z
