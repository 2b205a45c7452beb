"""Config system: dataclass configs and environment-variable overrides.

Port of ``madrona_tpu/utils/config.py``. Every config is a frozen
dataclass; :func:`env_override` applies ``MADRONA_TPU_<FIELD>``
overrides with the dataclass's own types, and :func:`apply_tuned`
overlays the port's tuning table, ``madrona_tpu_torch/tuned_configs.json``
(rows keyed by env name, then backend ``"cuda"``). Precedence, lowest to
highest: dataclass defaults, the tuned table, the environment. The
prefix is the JAX package's, so a variable set for its scripts sets the
port's field too: :func:`env_override` logs each field it changes, with
its variable, as a warning.

The table holds only its ``_meta`` row until a tuning run on the card
writes a ``"cuda"`` row; the JAX package's table tunes TPU VMEM knobs
that the port does not have and is never read.

The JAX package's ``enable_compile_cache`` configures JAX's compilation
cache and has no counterpart here: the port's compiled kernels are
cached by ``ops/cuda_build.py`` in ``_build/``, keyed by a hash of the
source and the flags.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import TypeVar

T = TypeVar("T")

PREFIX = "MADRONA_TPU"
BACKEND = "cuda"
_log = logging.getLogger(__name__)


def _parse(raw: str, ty):
    if ty is bool:
        return raw.lower() not in ("0", "false", "")
    if ty is int:
        return int(raw)
    if ty is float:
        return float(raw)
    if ty is str:
        return raw
    if ty is tuple or getattr(ty, "__origin__", None) is tuple:
        return tuple(float(x) for x in raw.split(","))
    return raw


def env_override(cfg: T, prefix: str = PREFIX) -> T:
    """Apply ``<prefix>_<FIELDNAME>`` environment overrides to a
    dataclass, parsed as the field's current value's type (e.g.
    ``MADRONA_TPU_SUBSTEPS=8`` sets PhysicsConfig.substeps). Unknown
    variables are ignored; a value that does not parse raises. Each
    field set is logged as a warning."""
    updates = {}
    for f in dataclasses.fields(cfg):
        var = f"{prefix}_{f.name.upper()}"
        if var in os.environ:
            ty = type(getattr(cfg, f.name))
            updates[f.name] = _parse(os.environ[var], ty)
            _log.warning("%s.%s = %r from %s", type(cfg).__name__, f.name,
                         updates[f.name], var)
    return dataclasses.replace(cfg, **updates) if updates else cfg


_TUNED_PATH = os.path.join(
    os.path.dirname(__file__), "..", "tuned_configs.json"
)
_tuned_cache = None


def load_tuned(env_name: str, backend: str = BACKEND) -> dict:
    """The tuned knobs of (env, backend) from the port's table, {} when
    the table or the row is absent (the dataclass defaults stand). Keys
    starting with ``bench_`` are a harness's (world count and the like)
    and :func:`apply_tuned` skips them."""
    global _tuned_cache
    if _tuned_cache is None:
        try:
            with open(_TUNED_PATH) as f:
                _tuned_cache = json.load(f)
        except (OSError, ValueError):
            _tuned_cache = {}
    row = _tuned_cache.get(env_name, {}).get(backend, {})
    # lists -> tuples: the returned dict shares nothing mutable with the
    # cache, and tuple fields need tuples
    return {
        k: (tuple(v) if isinstance(v, list) else v) for k, v in row.items()
    }


def apply_tuned(cfg: T, env_name: str) -> T:
    """Overlay the tuned table's knobs of ``env_name`` onto a config
    dataclass (call :func:`env_override` after this: the environment
    wins)."""
    tuned = load_tuned(env_name)
    names = {f.name for f in dataclasses.fields(cfg)}
    updates = {
        k: v for k, v in tuned.items()
        if k in names and not k.startswith("bench_")
    }
    return dataclasses.replace(cfg, **updates) if updates else cfg
