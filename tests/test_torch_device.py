"""The engine's entry points run on the card unless the caller asks for
the CPU: ``Executor`` and ``StateManager.init_state`` resolve
``device=None`` to ``"cuda"`` and raise where CUDA is absent, and build
on ``device="cpu"``. CUDA's absence is patched in inside each test, so
the tests hold on a machine with a card too."""

import pytest
import torch

from madrona_tpu_torch.core.registry import ECSRegistry
from madrona_tpu_torch.core.state import StateManager
from madrona_tpu_torch.graph.builder import TaskGraphManager
from madrona_tpu_torch.graph.executor import Executor
from madrona_tpu_torch.models.base import resolve_device
from madrona_tpu_torch.models.escape_room import EscapeRoom

torch.set_num_threads(1)


def _engine():
    """(StateManager, graphs) of the Escape Room, built through the
    engine API as an app would."""
    env = EscapeRoom()
    sm = StateManager()
    env.register_types(ECSRegistry(sm))
    mgr = TaskGraphManager(sm)
    env.setup_graphs(mgr)
    return sm, mgr.build_all()


def _executor(device):
    sm, graphs = _engine()
    if device is None:
        return Executor(sm, graphs, num_worlds=2)
    return Executor(sm, graphs, num_worlds=2, device=device)


def _init_state(device):
    sm, _ = _engine()
    if device is None:
        return sm.init_state(2)
    return sm.init_state(2, device=device)


@pytest.mark.parametrize("build", [_executor, _init_state],
                         ids=["executor", "init_state"])
def test_entry_point_defaults_to_the_card(monkeypatch, build):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        build(None)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        build("cuda")
    built = build("cpu")
    state = built.state if isinstance(built, Executor) else built
    assert state.step.device.type == "cpu"
    assert state.rng.device.type == "cpu"


def test_resolve_device_names_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
