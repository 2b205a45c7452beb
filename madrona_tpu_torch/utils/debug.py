"""Debug utilities: eager printing and NaN / index checks of a step.

Port of ``madrona_tpu/utils/debug.py``. The reference's HostPrint and
``Tensor::Printer`` become plain host prints (:func:`host_print`,
:func:`print_tensor`): the port runs eagerly, so a print inside a
system runs each step. The debug compile (the JAX package's checkify
with ``float_checks | index_checks``) becomes :func:`checked`, which
runs a step under a ``TorchDispatchMode`` that sees every aten op:

  * an op whose float inputs are all finite and whose output holds a
    NaN or an Inf marks that output with its name (and the taskgraph
    node it ran in); the mark follows the value through later ops until
    an op's output is finite again. Where a marked value reaches a
    node's output state or the checked function's result,
    :class:`CheckError` names the op that made it. The physics makes
    Inf and NaN in dead lanes on every clean step and masks them away
    (an infinite inverse mass times zero), so an op is not reported for
    a value that never reaches a result;
  * the index arguments of ``index``, ``index_select``, ``gather``,
    ``index_add``, ``scatter*`` and ``index_put`` are checked against
    the indexed size before the op launches (on the card an
    out-of-range gather is a device assert that ends the context).

The port's CUDA kernels are launched through ctypes, not as aten ops,
so ``checked`` also checks the state at every node boundary of
``graph/builder.py::TaskGraph.step``: a node after which a float leaf of
the state holds more non-finite values than before raises, naming the
node. ``checked`` only observes: a checked step's results are the
unchecked step's, bit for bit. Every check reads its answer on the host,
so a checked step runs at the host's pace.

:class:`RoundingSites`, another dispatch mode, lists the ops of a call
whose results the card can round apart from the CPU's on the same
inputs: a division by a Python number, ``linalg_vector_norm``, a float
sum of 3 or 4 terms over an axis (and, for review, products with Python
numbers).
"""

from __future__ import annotations

import contextvars
import dataclasses
import math
import os
import sys
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from . import tree as _tree


class CheckError(RuntimeError):
    """A check of :func:`checked` failed."""


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


def host_print(fmt: str, *args, **kwargs):
    """HostPrint::log: ``fmt.format(...)`` with tensors shown as numpy
    arrays, printed on the host."""
    print(fmt.format(*[_host(a) for a in args],
                     **{k: _host(v) for k, v in kwargs.items()}))


def print_tensor(name: str, value, summarize: bool = True):
    """Tensor::Printer: ``name: shape=(...) min=.. max=.. mean=..`` (the
    mean in float32), or the whole tensor with ``summarize=False``."""
    if summarize:
        host_print(
            name + ": shape={s} min={mn} max={mx} mean={me}",
            s=tuple(value.shape), mn=value.min(), mx=value.max(),
            me=value.to(torch.float32).mean(),
        )
    else:
        host_print(name + ": {v}", v=value)


# ------------------------------------------------------------- the checks

# ops that hand out memory they do not write: their outputs may hold
# anything
_UNINITIALIZED = {
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "resize_", "resize", "set_",
}
# (op, position of dim, position of index): index checked in [0, size)
_DIM_INDEX_OPS = {
    "index_select": (1, 2), "gather": (1, 2), "index_add": (1, 2),
    "index_add_": (1, 2), "index_copy": (1, 2), "index_copy_": (1, 2),
    "scatter": (1, 2), "scatter_": (1, 2), "scatter_add": (1, 2),
    "scatter_add_": (1, 2), "scatter_reduce": (1, 2),
    "scatter_reduce_": (1, 2),
}
# ops with a list of (optional) index tensors, one per leading dim
_LIST_INDEX_OPS = {"index", "index_put", "index_put_", "_index_put_impl_",
                   "_unsafe_index", "_unsafe_index_put"}


def _op_name(func) -> str:
    return func.__name__.split(".")[0]


def _all_true(flags) -> bool:
    """All of the 0-d bool tensors ``flags`` true: one host read a
    device."""
    by_device = {}
    for f in flags:
        by_device.setdefault(f.device, []).append(f)
    return all(bool(torch.stack(fs).all()) for fs in by_device.values())


def _finite(values) -> bool:
    """All float tensors and Python floats in ``values`` finite."""
    if any(isinstance(v, float) and not math.isfinite(v) for v in values):
        return False
    return _all_true([torch.isfinite(v).all() for v in values
                      if torch.is_tensor(v) and v.is_floating_point()
                      and v.numel()])


def _index_range(idx: torch.Tensor):
    both = torch.stack([idx.min(), idx.max()]).tolist()
    return both[0], both[1]


class _Checker(TorchDispatchMode):
    """The dispatch mode and the node-boundary check of one checked
    call."""

    def __init__(self):
        super().__init__()
        self.node: Optional[str] = None
        self._last = None     # (the last node's output state, its counts)
        # tensor -> the op that made its NaN or Inf values from finite ones
        self._made = WeakIdKeyDictionary()

    def _where(self) -> str:
        return f" in node {self.node!r}" if self.node else ""

    # -- indices -----------------------------------------------------------

    def _check_index(self, op, idx, size, lo):
        if not torch.is_tensor(idx) or idx.numel() == 0 or idx.dtype in (
                torch.bool, torch.uint8):
            return
        mn, mx = _index_range(idx)
        if mn < lo or mx >= size:
            raise CheckError(
                f"aten.{op}{self._where()}: index out of range: values in "
                f"[{mn}, {mx}], size {size}")

    def _check_indices(self, op, args):
        if op in _DIM_INDEX_OPS:
            d, i = _DIM_INDEX_OPS[op]
            if len(args) > i:
                src = args[0]
                dim = args[d] % max(src.dim(), 1)
                size = src.shape[dim] if src.dim() else 1
                self._check_index(op, args[i], size, 0)
        elif op in _LIST_INDEX_OPS and len(args) > 1:
            src, dim = args[0], 0
            for idx in args[1]:
                if idx is not None and idx.dtype in (torch.bool, torch.uint8):
                    dim += idx.dim()
                    continue
                if idx is not None:
                    size = src.shape[dim]
                    self._check_index(op, idx, size, -size)
                dim += 1

    # -- floats ------------------------------------------------------------

    def _origin(self, values, here: str) -> Optional[str]:
        """The origin to give a non-finite output of an op on ``values``:
        the origin of a marked input, else ``here`` where every float
        input is finite (at least one being a tensor), else None (the
        values were non-finite before the op: nothing of this call made
        them)."""
        for v in values:
            if torch.is_tensor(v) and v in self._made:
                return self._made[v]
        has_float = any(torch.is_tensor(v) and v.is_floating_point()
                        for v in values)
        return here if has_float and _finite(values) else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = _op_name(func)
        self._check_indices(op, args)
        if op in _UNINITIALIZED:
            return func(*args, **kwargs)
        here = f"aten.{op}{self._where()}"
        inputs = tree_leaves((args, kwargs))
        # an in-place op overwrites its inputs: read them first
        pre = (self._origin(inputs, here) if func._schema.is_mutable
               else False)
        out = func(*args, **kwargs)
        outs = [o for o in tree_leaves(out) if torch.is_tensor(o)
                and o.is_floating_point() and o.numel()]
        if outs and not _finite(outs):
            origin = self._origin(inputs, here) if pre is False else pre
            for o in outs:
                if origin is None:
                    self._made.pop(o, None)
                else:
                    self._made[o] = origin
        else:
            for o in outs:
                self._made.pop(o, None)
        return out

    def check_result(self, tree, what: str):
        """Raise if a float tensor of ``tree`` holds NaN or Inf values
        that an op of this call made from finite inputs."""
        for path, t in _float_leaves(tree, what).items():
            origin = self._made.get(t)
            if origin is not None:
                raise CheckError(f"{origin}: finite inputs gave a NaN or Inf "
                                 f"that reached {path}")

    # -- node boundaries ---------------------------------------------------

    @staticmethod
    def _nonfinite(state) -> Dict[str, int]:
        """{path: NaN and Inf count} of the float leaves of ``state``
        (one host read)."""
        leaves = _float_leaves(state)
        if not leaves:
            return {}
        with torch.utils._python_dispatch._disable_current_modes():
            dev = next(iter(leaves.values())).device
            counts = torch.stack([(~torch.isfinite(t)).sum().to(dev)
                                  for t in leaves.values()]).tolist()
        return dict(zip(leaves, counts))

    def run_node(self, name: str, fn: Callable, sm, state, key):
        """``fn(sm, state, key)`` with the node named in every report;
        raises if a float leaf of its output state holds more NaN or Inf
        values than its input state did."""
        if self._last is not None and self._last[0] is state:
            before = self._last[1]
        else:
            before = self._nonfinite(state)
        self.node = name
        try:
            new = fn(sm, state, key)
        finally:
            self.node = None
        self.check_result(new, "state")
        after = self._nonfinite(new)
        for path, n in after.items():
            if n > before.get(path, 0):
                raise CheckError(
                    f"node {name!r}: {path} holds {n} NaN or Inf values "
                    f"after the node, {before.get(path, 0)} before it")
        self._last = (new, after)
        return new


def _float_leaves(tree, prefix="state") -> Dict[str, torch.Tensor]:
    """{path: tensor} of the floating-point tensors in ``tree``."""
    return {path: t for path, t in _tree.tree_leaves(tree, prefix)
            if t.is_floating_point() and t.numel()}


# The checker of the checked call running in this context, read by
# TaskGraph.step at its node boundaries (None: unchecked).
NODE_CHECK: contextvars.ContextVar = contextvars.ContextVar(
    "madrona_tpu_torch_node_check", default=None)


# ------------------------------------------------- the card's rounding

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
_SUM_OPS = {"sum", "mean", "nansum"}


@dataclasses.dataclass(frozen=True)
class RoundingSite:
    """An aten op whose result can round apart on the card and on the CPU
    from the same inputs. ``kind``: ``"div"`` (a division by a Python
    number other than a power of two, which the card turns into a
    product with its reciprocal), ``"mul"`` (a product with such a
    number: the same bits on both, listed because it may stand for a
    division), ``"norm"`` (``linalg_vector_norm``: the card sums the
    squares in another order) or ``"sum"`` (a float sum or mean of 3 or 4
    terms over one axis, which the card pairs). ``where``: the innermost
    line of this package that called it, relative to the package."""

    kind: str
    op: str
    where: str
    detail: str = ""


def _is_number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _power_of_two(x) -> bool:
    """0, or +-2^k: a product or quotient with it rounds alike on the
    card and the CPU."""
    return x == 0 or math.frexp(abs(x))[0] == 0.5


def _caller() -> str:
    """``file:line`` of the innermost frame of this package outside this
    file."""
    f = sys._getframe(1)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(_PACKAGE) and path != os.path.abspath(__file__):
            return f"{path[len(_PACKAGE):]}:{f.f_lineno}"
        f = f.f_back
    return "?"


class RoundingSites(TorchDispatchMode):
    """Lists in ``sites`` every :class:`RoundingSite` of the ops run
    under it, in order, each once; the ops' results are unchanged::

        with RoundingSites() as mode:
            sim.step(inputs)
        print(mode.sites)
    """

    def __init__(self):
        super().__init__()
        self.sites = []
        self._seen = set()

    def _add(self, kind, op, detail=""):
        site = RoundingSite(kind, op, _caller(), detail)
        if site not in self._seen:
            self._seen.add(site)
            self.sites.append(site)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = _op_name(func)
        x = args[0] if args else None
        floats = torch.is_tensor(x) and x.is_floating_point()
        if op in ("div", "div_", "mul", "mul_") and floats \
                and len(args) > 1 and _is_number(args[1]) \
                and not _power_of_two(args[1]):
            div = op.startswith("div")
            self._add("div" if div else "mul", op,
                      f"{'/' if div else '*'} {args[1]!r}")
        elif op == "linalg_vector_norm":
            self._add("norm", op)
        elif op in _SUM_OPS and floats and len(args) > 1 and args[1]:
            dims = args[1] if isinstance(args[1], (list, tuple)) else [args[1]]
            terms = math.prod(x.shape[d] for d in dims) if x.dim() else 1
            if 2 < terms <= 4:
                self._add("sum", op, f"{terms} terms")
        return func(*args, **kwargs)


def checked(fn: Callable) -> Callable:
    """``fn`` with float and index checks (the reference's Debug-mode
    compile, ``CompileConfig::OptMode::Debug``): the returned function
    raises :class:`CheckError` where a NaN or Inf made from finite values
    reaches a node's output state or the result (naming the op that made
    it), where a node's output state holds more NaN or Inf than its input
    (naming the node), and on an out-of-range index (naming the op); its
    results are ``fn``'s, bit for bit."""

    def wrapped(*args, **kwargs):
        checker = _Checker()
        token = NODE_CHECK.set(checker)
        try:
            with checker:
                out = fn(*args, **kwargs)
            checker.check_result(out, "the result")
            return out
        finally:
            NODE_CHECK.reset(token)

    return wrapped

