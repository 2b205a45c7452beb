"""The ECS core of the PyTorch port vs the JAX package.

Components, bundles and queries; the entity store (alloc, free, lookup,
update_rows); entity creation and destruction (make_entities past
capacity, destroy_entities, append_temporaries, append_rows, clear,
gather_rows); the taskgraph's node kinds (parallel_for with its row
keys, rows, handles and liveness, for_worlds, sort by a component and by
a key function, compact, clear_tmp); and capacity growth (overflow
counts, maybe_grow). The cases are those of tests/test_ecs.py,
test_lifecycle.py, test_taskgraph.py, test_capacity_growth.py,
test_churn_handles.py and test_churn_property.py. The same random
batches go through both packages, and every output and the whole state
after each operation must be equal bit for bit: ids, generations, rows,
the free stack, columns, counts, overflow. Tolerance: none (exact). The
churn property runs under hypothesis with a bounded number of examples.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from madrona_tpu.core import archetype as j_arch
from madrona_tpu.core import component as j_comp
from madrona_tpu.core import entity_store as j_es
from madrona_tpu.core.registry import ECSRegistry as JRegistry
from madrona_tpu.core.state import StateManager as JStateManager
from madrona_tpu.graph.builder import TaskGraphBuilder as JBuilder
from madrona_tpu.graph.executor import Executor as JExecutor
from madrona_tpu.ops.lifecycle import destroy_entities as j_destroy
from madrona_tpu_torch.core import archetype as t_arch
from madrona_tpu_torch.core import component as t_comp
from madrona_tpu_torch.core import entity_store as t_es
from madrona_tpu_torch.core.registry import ECSRegistry as TRegistry
from madrona_tpu_torch.core.state import StateManager as TStateManager
from madrona_tpu_torch.graph.builder import TaskGraphBuilder as TBuilder
from madrona_tpu_torch.graph.executor import Executor as TExecutor
from madrona_tpu_torch.interop import state_to_numpy
from madrona_tpu_torch.ops.lifecycle import destroy_entities as t_destroy

from torch_port import assert_trees_equal, jax_tree

torch.set_num_threads(1)


@dataclasses.dataclass
class Side:
    """One package's half of the ECS API, under common names."""

    name: str
    Registry: type
    StateManager: type
    Builder: type
    es: object
    arch: object
    comp: object
    destroy: object
    f32: object
    i32: object
    arr: object        # numpy -> the package's array
    round: object

    def sm(self):
        return self.StateManager()

    def executor(self, sm, graphs, **kw):
        if self.name == "jax":
            return JExecutor(sm, graphs, donate=False, **kw)
        return TExecutor(sm, graphs, device="cpu", **kw)

    def state_tree(self, state):
        return jax_tree(state) if self.name == "jax" else state_to_numpy(state)


JAX = Side("jax", JRegistry, JStateManager, JBuilder, j_es, j_arch, j_comp,
           j_destroy, jnp.float32, jnp.int32, jnp.asarray, jnp.round)
TORCH = Side("torch", TRegistry, TStateManager, TBuilder, t_es, t_arch,
             t_comp, t_destroy, torch.float32, torch.int32,
             lambda a: torch.from_numpy(np.array(a)), torch.round)
SIDES = (JAX, TORCH)


def same(a, b, what="state"):
    """Two values of the same kind (a state, a store, a tuple of arrays)
    equal bit for bit."""
    if hasattr(a, "tables"):
        assert_trees_equal(JAX.state_tree(a), TORCH.state_tree(b), what)
    elif isinstance(a, tuple):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{what}[{i}]")
    else:
        assert_trees_equal(jax_tree(a), jax_tree(b), what)


def both(fn, *args):
    """fn(side, *args) on each side; returns (jax result, torch result)."""
    return tuple(fn(side, *args) for side in SIDES)


# ------------------------------------------------- components, bundles


def test_components_bundles_and_query():
    e = np.array([[3, 5], [-1, -1], [0, 7]], np.int32)
    for f in ("gen", "id", "is_none"):
        np.testing.assert_array_equal(
            np.asarray(getattr(t_comp.Entity, f)(torch.from_numpy(e))),
            np.asarray(getattr(j_comp.Entity, f)(jnp.asarray(e))), f)
    same(j_comp.Entity.none((2, 3)), t_comp.Entity.none((2, 3)), "none")
    same(j_comp.Entity.make(jnp.asarray(e[:, 0]), jnp.asarray(e[:, 1])),
         t_comp.Entity.make(torch.from_numpy(e[:, 0]),
                            torch.from_numpy(e[:, 1])), "make")
    assert t_comp.NULL_ENTITY == j_comp.NULL_ENTITY
    for f in ("scalar", "vec2", "vec3", "vec4", "quat", "entity_ref"):
        (js, jd), (ts, td) = getattr(j_comp, f)(), getattr(t_comp, f)()
        assert js == ts and np.dtype(jd).name == str(td).split(".")[-1], f

    def build(side):
        sm = side.sm()
        reg = side.Registry(sm)
        for c in ("Pos", "Vel", "Health", "Extra"):
            reg.register_component(c, (3,), side.f32)
        reg.register_bundle("Body", ["Pos", "Vel"])
        reg.register_bundle("Full", ["Body", "Health", "Pos"])
        reg.register_bundle_alias("Body2", "Body")
        reg.register_archetype("Agent", ["Full", "Extra", "Vel"], 4)
        reg.register_archetype("Ghost", ["Body2"], 2)
        reg.register_archetype("Rock", ["Extra"], 3)
        errs = []
        for call in (lambda: reg.register_bundle("Pos", ["Vel"]),
                     lambda: reg.register_bundle("B3", ["Nope"]),
                     lambda: reg.register_bundle_alias("A", "Nope"),
                     lambda: reg.register_bundle_alias("Body", "Full"),
                     lambda: reg.register_archetype("X", ["Body", "Nope"],
                                                    1)):
            with pytest.raises(ValueError) as info:
                call()
            errs.append(str(info.value))
        return (sm.bundles, {k: a.components for k, a in sm.archetypes.items()},
                [sm.query(*q) for q in (("Pos",), ("Pos", "Health"),
                                        ("Extra",), ("Nope",))],
                [sm.arch_index(a) for a in ("Agent", "Ghost", "Rock")], errs)

    j, t = both(build)
    assert j == t
    assert t[1]["Agent"] == ("Pos", "Vel", "Health", "Extra")


# ------------------------------------------------------------ entity store


def test_entity_store_ops_equal_jax():
    """Rounds of alloc (the stack running out), free (live, stale, doubled,
    null and out-of-range handles), lookup and update_rows (stale
    generations, ids past the store) on random batches."""
    w, max_e, k = 3, 12, 5
    rs = np.random.RandomState(0)
    stores = [side.es.init(w, max_e) if side is JAX
              else side.es.init(w, max_e, "cpu") for side in SIDES]
    issued = np.zeros((w, 0, 2), np.int32)
    for rnd in range(7):
        valid = rs.rand(w, k) < 0.7
        base = rs.randint(0, 6, w).astype(np.int32)
        outs = [side.es.alloc(st_, side.arr(valid), 1 + rnd % 2,
                              side.arr(base))
                for side, st_ in zip(SIDES, stores)]
        same(outs[0], outs[1], f"alloc {rnd}")
        stores = [o[0] for o in outs]
        issued = np.concatenate([issued, np.asarray(outs[0][1])], axis=1)
        # a batch of handles: issued ones (some now stale), a doubled one,
        # null, negative and past-the-store ids, random generations
        pick = issued[:, rs.randint(0, issued.shape[1], 6)]
        junk = np.stack([rs.randint(-1, 3, (w, 4)),
                         rs.choice([-3, -1, 0, 5, max_e, max_e + 4], (w, 4))],
                        axis=-1).astype(np.int32)
        batch = np.concatenate([pick, pick[:, :1], junk], axis=1)
        fvalid = rs.rand(w, batch.shape[1]) < 0.8
        stores = [side.es.free(st_, side.arr(batch), side.arr(fvalid))
                  for side, st_ in zip(SIDES, stores)]
        same(stores[0], stores[1], f"free {rnd}")
        looks = [side.es.lookup(st_, side.arr(batch))
                 for side, st_ in zip(SIDES, stores)]
        same(looks[0], looks[1], f"lookup {rnd}")
        # update_rows on a random table of ids and generations
        eid = rs.randint(-1, max_e + 2, (w, 6)).astype(np.int32)
        gen = rs.randint(-1, 3, (w, 6)).astype(np.int32)
        live = rs.rand(w, 6) < 0.8
        stores = [side.es.update_rows(st_, side.arr(eid), side.arr(gen),
                                      side.arr(live))
                  for side, st_ in zip(SIDES, stores)]
        same(stores[0], stores[1], f"update_rows {rnd}")
    assert int(np.asarray(stores[0].free_top).min()) < max_e


# ------------------------------------------- entity creation, destruction


def _thing_sm(side, cap=8):
    sm = side.sm()
    reg = side.Registry(sm)
    reg.register_component("Val", (), side.f32)
    reg.register_component("Body", fields={"p": ((3,), side.f32),
                                           "tag": ((), side.i32)})
    reg.register_component("Pair", (2,), side.i32)
    reg.register_archetype("Other", ["Val"], 4)
    reg.register_archetype("Thing", ["Val", "Body"], cap)
    reg.register_archetype("Fixed", ["Val"], 3, fixed_rows=True)
    reg.register_archetype("Tmp", ["Pair"], 6, temporary=True)
    return sm


def test_make_and_destroy_equal_jax():
    """make_entities past capacity (no handle past the table, drops
    counted into overflow), destroy_entities with stale, doubled and
    other-archetype handles, append_temporaries, append_rows, clear and
    gather_rows, on random batches; fixed rows refuse destruction."""
    w, k = 3, 5
    rs = np.random.RandomState(1)
    sms = [_thing_sm(side) for side in SIDES]
    states = [sms[0].init_state(w, seed=2),
              sms[1].init_state(w, seed=2, device="cpu")]
    ents_all = []
    for rnd in range(5):
        vals = {"Val": rs.randn(w, k).astype(np.float32),
                "Body": {"p": rs.randn(w, k, 3).astype(np.float32),
                         "tag": rs.randint(0, 9, (w, k)).astype(np.int32)}}
        valid = rs.rand(w, k) < 0.8
        outs = []
        for side, sm, s in zip(SIDES, sms, states):
            v = {"Val": side.arr(vals["Val"]),
                 "Body": {f: side.arr(a) for f, a in vals["Body"].items()}}
            outs.append(sm.make_entities(s, "Thing", v, side.arr(valid)))
        same(outs[0][0], outs[1][0], f"make {rnd}")
        same(outs[0][1], outs[1][1], f"make handles {rnd}")
        o_v = {"Val": rs.randn(w, 2).astype(np.float32)}
        states = [sm.make_entities(o[0], "Other",
                                   {"Val": side.arr(o_v["Val"])},
                                   side.arr(np.ones((w, 2), bool)))[0]
                  for side, sm, o in zip(SIDES, sms, outs)]
        ents_all.append(np.asarray(outs[0][1]))
        other = np.asarray(jax_tree(states[0].tables["Other"])["entity_id"])
        # destroy: issued handles (some stale), a doubled one, handles of
        # the other archetype
        pool = np.concatenate(ents_all, axis=1)
        kill = pool[:, rs.randint(0, pool.shape[1], 4)]
        other_h = np.stack([np.zeros_like(other[:, :1]), other[:, :1]],
                           axis=-1).astype(np.int32)
        kill = np.concatenate([kill, kill[:, :1], other_h], axis=1)
        kvalid = rs.rand(w, kill.shape[1]) < 0.7
        states = [side.destroy(sm, s, "Thing", side.arr(kill),
                               side.arr(kvalid))
                  for side, sm, s in zip(SIDES, sms, states)]
        same(states[0], states[1], f"destroy {rnd}")
        # temporaries
        pairs = rs.randint(0, 50, (w, 4, 2)).astype(np.int32)
        tvalid = rs.rand(w, 4) < 0.6
        states = [sm.append_temporaries(s, "Tmp", {"Pair": side.arr(pairs)},
                                        side.arr(tvalid))
                  for side, sm, s in zip(SIDES, sms, states)]
        same(states[0], states[1], f"append_temporaries {rnd}")
    assert (np.asarray(jax_tree(states[0].tables["Thing"])["overflow"])
            > 0).all()
    tabs = [s.tables["Tmp"] for s in states]
    one = rs.randint(0, 50, (w, 2)).astype(np.int32)
    amask = np.array([True, False, True])
    tabs = [side.arch.append_rows(t, {"Pair": side.arr(one)},
                                  side.arr(amask))
            for side, t in zip(SIDES, tabs)]
    same(tabs[0], tabs[1], "append_rows")
    perm = np.stack([rs.permutation(6) for _ in range(w)]).astype(np.int32)
    same(*[side.arch.gather_rows(t, side.arr(perm))
           for side, t in zip(SIDES, tabs)], "gather_rows")
    same(*[side.arch.clear(t) for side, t in zip(SIDES, tabs)], "clear")
    for side, sm, s in zip(SIDES, sms, states):
        with pytest.raises(ValueError):
            side.destroy(sm, s, "Fixed", side.arr(np.zeros((w, 1, 2),
                                                           np.int32)),
                         side.arr(np.ones((w, 1), bool)))


# ------------------------------------------------------ taskgraph nodes


def _graph_sim(side, w=4):
    """test_taskgraph.py's movers with a row-inspecting parallel_for, a
    fixed-rows archetype capturing each row's key, a world counter, both
    sorts (with ties), compact and clear_tmp."""
    sm = side.sm()
    reg = side.Registry(sm)
    reg.register_component("Pos", (), side.f32)
    reg.register_component("Vel", (), side.f32)
    reg.register_component("Key", (), side.i32)
    reg.register_component("Seen", (), side.i32)
    reg.register_component("KeyW", (2,), side.i32)
    reg.register_component("Body", fields={"p": ((3,), side.f32),
                                           "v": ((3,), side.f32)})
    reg.register_archetype("Mover", ["Pos", "Vel", "Key", "Seen"], 8)
    reg.register_archetype("Cell", ["KeyW", "Body"], 3, fixed_rows=True)
    reg.register_archetype("Tmp", ["Pos"], 4, temporary=True)
    reg.register_singleton("StepCount", (), side.i32)
    reg.register_singleton("WorldSum", (), side.i32)

    def movement(ctx, pos, vel):
        return pos + vel

    def inspect(ctx, seen):
        # the row, its liveness and its handle, as the system sees them
        return (seen + ctx.row * 10 + ctx.is_valid * 1000
                + ctx.entity[1] * 100000 + ctx.entity[0] * 10000000)

    def grab_key(ctx, kw, body):
        # the 32-bit key words, cut to 16 bits each so int32 holds them
        return (ctx.key % 65536,
                {"p": body["p"] + body["v"], "v": body["v"]})

    def count(ctx, c, s):
        return c + 1, s + ctx.world_id + ctx.key[0] % 7

    b = side.Builder(sm)
    n0 = b.parallel_for(movement, "Mover", ["Pos", "Vel"], ["Pos"])
    n1 = b.parallel_for(inspect, "Mover", ["Seen"], ["Seen"], deps=[n0])
    n2 = b.parallel_for(grab_key, "Cell", ["KeyW", "Body"],
                        ["KeyW", "Body"], deps=[n1])
    n3 = b.for_worlds(count, ["StepCount", "WorldSum"],
                      ["StepCount", "WorldSum"], deps=[n2])
    n4 = b.sort("Mover", key_comp="Key", deps=[n3])
    n5 = b.sort("Mover", key_fn=lambda c: -side.round(c["Pos"] / 3.0),
                deps=[n4])
    n6 = b.compact("Mover", deps=[n5])
    b.clear_tmp("Tmp", deps=[n6])

    def init(sm_, state):
        k = 6
        vals = {
            "Pos": side.arr(np.tile(np.arange(k, dtype=np.float32), (w, 1))),
            "Vel": side.arr(np.ones((w, k), np.float32)),
            "Key": side.arr(np.tile(np.arange(k) % 3, (w, 1)).astype(
                np.int32)),
            "Seen": side.arr(np.zeros((w, k), np.int32)),
        }
        valid = np.ones((w, k), bool)
        valid[1, 4:] = False
        valid[2, :] = False
        state, _ = sm_.make_entities(state, "Mover", vals, side.arr(valid))
        return sm_.append_temporaries(
            state, "Tmp", {"Pos": side.arr(np.ones((w, 3), np.float32))},
            side.arr(np.ones((w, 3), bool)))

    return side.executor(sm, {"step": b.build()}, num_worlds=w, seed=5,
                         init_fn=init)


def test_taskgraph_nodes_equal_jax():
    """Three steps of every node kind; the state after each, bit for
    bit. Dead rows keep their values; the store is re-pointed."""
    exs = both(_graph_sim)
    same(exs[0].state, exs[1].state, "init")
    for t in range(3):
        for ex in exs:
            ex.run()
        same(exs[0].state, exs[1].state, f"step {t}")
    seen = exs[1].state.tables["Mover"].columns["Seen"]
    assert int(seen[2].abs().sum()) == 0 and int(seen[0, 0]) != 0
    keys = exs[1].state.tables["Cell"].columns["KeyW"].reshape(-1, 2)
    assert len({tuple(r) for r in keys.tolist()}) == keys.shape[0]


# ------------------------------------------------------- capacity growth


def _growth_exec(side, cap=4, spawn_per_step=3, w=4):
    sm = side.sm()
    reg = side.Registry(sm)
    reg.register_component("Val", (), side.i32)
    reg.register_archetype("Things", ["Val"], capacity=cap)
    reg.register_singleton("Count", (), side.i32)
    reg.export_singleton("Count", "count")

    def spawn(sm_, state, key):
        vals = {"Val": side.arr(np.ones((w, spawn_per_step), np.int32))}
        state, _ = sm_.make_entities(
            state, "Things", vals,
            side.arr(np.ones((w, spawn_per_step), bool)))
        singles = dict(state.singletons)
        singles["Count"] = state.tables["Things"].num_rows
        return dataclasses.replace(state, singletons=singles)

    b = side.Builder(sm, "step")
    b.custom(spawn, name="spawn")
    return side.executor(sm, {"step": b.build()}, num_worlds=w, seed=0,
                         max_entities=64)


def test_capacity_growth_equal_jax():
    """Overflow counts, maybe_grow's new capacity (4 -> 8, then 8 -> 16),
    the padded tables and the steps after growth; growth never
    shrinks."""
    exs = both(_growth_exec)
    for t in range(5):
        for ex in exs:
            ex.run()
        counts = [ex.overflow_counts() for ex in exs]
        assert counts[0] == counts[1], (t, counts)
        grown = [ex.maybe_grow() for ex in exs]
        assert grown[0] == grown[1], (t, grown)
        assert dataclasses.asdict(exs[0].sm.archetypes["Things"]) == \
            dataclasses.asdict(exs[1].sm.archetypes["Things"])
        same(exs[0].state, exs[1].state, f"step {t}")
    assert exs[1].sm.archetypes["Things"].capacity == 16
    np.testing.assert_array_equal(
        exs[1].sm.collect_exports(exs[1].state)["count"].numpy(),
        np.asarray(exs[0].get_exported("count")))
    for ex in exs:
        with pytest.raises(ValueError):
            ex.grow_archetype("Things", 2)


# ------------------------------------------------------------------ churn

W, CAP, KK, SK = 3, 16, 6, 5


def _churn_exec(side, sort_only=False):
    """test_churn_property.py's graph (kill -> spawn -> sort -> compact),
    or test_churn_handles.py's (kill the original of index t -> spawn
    one -> sort) with ``sort_only``."""
    sm = side.sm()
    reg = side.Registry(sm)
    reg.register_component("Val", (), side.f32)
    reg.register_archetype("Thing", ["Val"], capacity=CAP if not sort_only
                           else 32)
    reg.register_singleton("KillH", (KK, 2), side.i32)
    reg.register_singleton("SpawnV", (SK,), side.f32)
    reg.register_singleton("SpawnM", (SK,), side.i32)
    reg.register_singleton("T", (), side.i32)
    for name in ("KillH", "SpawnV", "SpawnM", "T"):
        reg.import_singleton(name, name.lower())

    def kill(sm_, state, _key):
        h = state.singletons["KillH"]
        if sort_only:
            tab = state.tables["Thing"]
            val = tab.columns["Val"]
            live = side.arch.row_mask(tab, val.shape[1])
            idx = side.round(val) % 100.0
            t = state.singletons["T"]
            kill_m = live & (val < 1000.0) & (idx == t[:, None] * 1.0)
            handles = side.comp.Entity.make(tab.entity_gen, tab.entity_id)
            return side.destroy(sm_, state, "Thing", handles, kill_m)
        return side.destroy(sm_, state, "Thing", h, h[..., 0] > -100)

    def spawn(sm_, state, _key):
        v = state.singletons["SpawnV"]
        m = state.singletons["SpawnM"] > 0
        state, _ = sm_.make_entities(state, "Thing", {"Val": v}, m)
        return state

    def init(sm_, state):
        vals = (100.0 * np.arange(W, dtype=np.float32)[:, None]
                + np.arange(8, dtype=np.float32)[None, :])
        state, _ = sm_.make_entities(state, "Thing", {"Val": side.arr(vals)},
                                     side.arr(np.ones((W, 8), bool)))
        return state

    b = side.Builder(sm, "step")
    n0 = b.custom(kill, name="kill")
    n1 = b.custom(spawn, deps=[n0], name="spawn")
    n2 = b.sort("Thing",
                key_fn=lambda cols: side.round(cols["Val"] * 37.0) % 101.0,
                deps=[n1])
    if not sort_only:
        b.compact("Thing", deps=[n2])
    return side.executor(sm, {"step": b.build()}, num_worlds=W, init_fn=init)


def _churn_inputs(side, killh, spawn_v, spawn_m, t=0):
    return {"killh": side.arr(killh), "spawnv": side.arr(spawn_v),
            "spawnm": side.arr(spawn_m),
            "t": side.arr(np.full((W,), t, np.int32))}


def test_churn_handles_equal_jax():
    """Each step one original entity dies, one spawns, and the table is
    shuffled by its sort: state and every held handle's lookup equal."""
    exs = [_churn_exec(side, sort_only=True) for side in SIDES]
    tab = exs[0].state.tables["Thing"]
    held = np.stack([np.asarray(tab.entity_gen)[:, :8],
                     np.asarray(tab.entity_id)[:, :8]], axis=-1)
    killh = np.full((W, KK, 2), -1, np.int32)
    for t in range(8):
        spawn_v = np.zeros((W, SK), np.float32)
        spawn_v[:, 0] = 1000.0 + 10.0 * t + np.arange(W)
        spawn_m = np.zeros((W, SK), np.int32)
        spawn_m[:, 0] = 1
        for side, ex in zip(SIDES, exs):
            ex.run(inputs=_churn_inputs(side, killh, spawn_v, spawn_m, t))
        same(exs[0].state, exs[1].state, f"step {t}")
        looks = [side.es.lookup(ex.state.entities, side.arr(held))
                 for side, ex in zip(SIDES, exs)]
        same(looks[0], looks[1], f"lookup {t}")
        np.testing.assert_array_equal(
            np.asarray(looks[1][2]), np.broadcast_to(np.arange(8) > t, (W, 8)))


@pytest.fixture(scope="module")
def churn_pair():
    exs = [_churn_exec(side) for side in SIDES]
    return exs, [ex.state for ex in exs]


@settings(max_examples=10, deadline=None)
@given(data=st.data())
def test_churn_property_equal_jax(churn_pair, data):
    """Random streams of kills (live handles of the table, stale and
    doubled ones, junk) and spawns (past capacity at times), through
    kill -> spawn -> sort -> compact: the state after every step equal."""
    exs, init = churn_pair
    for ex, s in zip(exs, init):
        ex.state = s
    for t in range(data.draw(st.integers(2, 6))):
        tab = jax_tree(exs[0].state.tables["Thing"])
        rows = np.asarray(data.draw(st.lists(
            st.integers(0, CAP - 1), min_size=W * KK, max_size=W * KK)))
        killh = np.stack([tab["entity_gen"], tab["entity_id"]], axis=-1)[
            np.repeat(np.arange(W), KK), rows].reshape(W, KK, 2)
        junk = np.asarray(data.draw(st.lists(
            st.integers(-2, 40), min_size=W * KK * 2,
            max_size=W * KK * 2))).reshape(W, KK, 2)
        use_junk = np.asarray(data.draw(st.lists(
            st.booleans(), min_size=W * KK, max_size=W * KK))).reshape(W, KK)
        killh = np.where(use_junk[..., None], junk, killh).astype(np.int32)
        killh[:, -1] = killh[:, 0]                      # a doubled handle
        spawn_m = np.asarray(data.draw(st.lists(
            st.booleans(), min_size=W * SK, max_size=W * SK))).reshape(
                W, SK).astype(np.int32)
        spawn_v = (np.arange(W * SK, dtype=np.float32).reshape(W, SK)
                   + 100.0 * t)
        for side, ex in zip(SIDES, exs):
            ex.run(inputs=_churn_inputs(side, killh, spawn_v, spawn_m))
        same(exs[0].state, exs[1].state, f"step {t}")
