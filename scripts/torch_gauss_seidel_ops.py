#!/usr/bin/env python3
"""Which op makes the card's Gauss-Seidel step part from the CPU's.

chip_smoke.py phase 29 steps the box stack with a sphere and joints
(``chip_smoke.stack_scene``, ``solver="gauss_seidel"``) on the card and,
at its check points, steps worlds 0-7 once on the card and once on the
CPU from the same state. After step 16 one body's velocity differs by
more than the golden bound. Both devices run the same plain PyTorch
code (B1 is exact), so some op rounds differently on the card. This
script finds it:

1. it steps the stack on the card to ``--at``, carries worlds 0-7 to the
   card and to the CPU and steps both once (``--save`` writes the carried
   state with ``utils.checkpoint.save_npz``, which the JAX package's
   ``load_npz`` reads too);
2. it steps the card again under a dispatch mode that runs every aten op
   a second time on CPU copies of the card's inputs, and lists the ops
   whose outputs differ in any bit (by name: calls, calls that differ,
   largest difference);
3. it routes every such op to the CPU (computed there, copied back) and
   checks that the card's step then equals the CPU's bit for bit; then,
   for each name, routes all the others: the difference that name alone
   makes;
4. for a name that alone puts a body outside a golden bound, it bisects
   that name's calls (only the calls in a range stay on the card) down
   to the fewest calls that still do, and prints each one's source line,
   inputs and outputs on both devices for the world that parts.

Run on the card: python3 scripts/torch_gauss_seidel_ops.py [--at 16]
[--save chiprun_out/gs_state.npz]. ``--device cpu --perturb NAME``
rehearses the search on the CPU: the "card" is the CPU and NAME's
float32 outputs are scaled by 1 + 1e-3 there (not in step 1).
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def _tensors(tree):
    import torch
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _bits_differ(a, b):
    """[numel] bool: elements of a and b (any devices) that differ in a
    bit (NaNs of the same bits equal)."""
    import torch

    a, b = a.detach().cpu().reshape(-1), b.detach().cpu().reshape(-1)
    if a.dtype.is_floating_point and a.dtype.itemsize in (2, 4, 8):
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        return a.view(ints[a.dtype.itemsize]) != b.view(
            ints[a.dtype.itemsize])
    return a != b


def _written(func, args, kwargs):
    """The tensors an op writes in place (its schema's mutable args)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            out.append(args[i] if i < len(args) else kwargs.get(a.name))
    return out


def _source():
    """The innermost frames of the port's code that made the current op."""
    frames = [f for f in traceback.extract_stack()
              if "madrona_tpu_torch" in f.filename]
    return " <- ".join(f"{os.path.relpath(f.filename, HERE)}:{f.lineno} "
                       f"{f.name}" for f in reversed(frames[-3:]))


class _Twin:
    """Runs an aten op on the card's tensors and on CPU copies of them."""

    def __init__(self, card):
        self.card = card

    def cpu_copies(self, args, kwargs):
        import torch
        from torch.utils._pytree import tree_map

        def to_cpu(x):
            if isinstance(x, torch.Tensor):
                return x.detach().to("cpu", copy=True)
            if isinstance(x, torch.device) and x.type == self.card.type:
                return torch.device("cpu")
            return x
        return tree_map(to_cpu, (args, kwargs))

    def on_card(self, args, kwargs):
        return any(t.device == self.card for t in _tensors((args, kwargs)))


def make_modes(card, perturb=None):
    """(Compare, Route) dispatch modes for the card device ``card``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_map

    def card_call(func, args, kwargs):
        out = func(*args, **kwargs)
        if perturb and str(func) == perturb:
            def up(t):
                if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                    return t * (1 + 1e-3)
                return t
            out = tree_map(up, out)
        return out

    class Compare(TorchDispatchMode):
        """Every op on the card, again on the CPU: {name: [calls, calls
        that differ, largest difference, first source line]}."""

        def __init__(self):
            super().__init__()
            self.twin, self.seen = _Twin(card), {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if not self.twin.on_card(args, kwargs):
                return func(*args, **kwargs)
            c_args, c_kwargs = self.twin.cpu_copies(args, kwargs)
            out = card_call(func, args, kwargs)
            ref = func(*c_args, **c_kwargs)
            rec = self.seen.setdefault(str(func), [0, 0, 0.0, None])
            rec[0] += 1
            got, want = _tensors(out), _tensors(ref)
            differ, worst = len(got) != len(want), 0.0
            for g, w in zip(got, want):
                if g.shape != w.shape:
                    differ = True
                    continue
                d = _bits_differ(g, w)
                if bool(d.any()):
                    differ = True
                    if g.dtype.is_floating_point:
                        worst = max(worst, float(
                            (g.detach().cpu().double() - w.double())
                            .abs().reshape(-1)[d].max()))
            if differ:
                rec[1] += 1
                rec[2] = max(rec[2], worst)
                rec[3] = rec[3] or _source()
            return out

    class Route(TorchDispatchMode):
        """Ops named in ``names`` computed on the CPU and copied back to
        the card, except the calls of ``keep`` whose index (counted among
        ``keep``'s calls) lies in ``window`` [lo, hi), which stay on the
        card; ``log`` collects (index, source, inputs, card and CPU
        outputs) of the calls in the window."""

        def __init__(self, names, keep=None, window=(0, 0), log=None):
            super().__init__()
            self.twin, self.names, self.keep = _Twin(card), names, keep
            self.window, self.log, self.calls = window, log, 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = str(func)
            if not self.twin.on_card(args, kwargs):
                return func(*args, **kwargs)
            if name not in self.names:
                return card_call(func, args, kwargs)
            if name == self.keep:
                i, self.calls = self.calls, self.calls + 1
                if self.window[0] <= i < self.window[1]:
                    if self.log is None:
                        return card_call(func, args, kwargs)
                    c_args, c_kwargs = self.twin.cpu_copies(args, kwargs)
                    out = card_call(func, args, kwargs)
                    self.log.append((i, _source(), c_args,
                                     tree_map(lambda t: t.detach().cpu()
                                              if isinstance(t, torch.Tensor)
                                              else t, out),
                                     func(*c_args, **c_kwargs)))
                    return out
            c_args, c_kwargs = self.twin.cpu_copies(args, kwargs)
            ref = func(*c_args, **c_kwargs)
            back = {}
            for a, c in zip(_written(func, args, kwargs),
                            _written(func, c_args, c_kwargs)):
                a.copy_(c)                      # what the op wrote in place
                back[id(c)] = a
            return tree_map(lambda t: back.get(id(t), t.to(card))
                            if isinstance(t, torch.Tensor) else t, ref)

    return Compare, Route


def main(argv=None):
    import torch

    import chip_smoke as cs
    from madrona_tpu_torch.physics.xpbd import PhysicsConfig
    from madrona_tpu_torch.utils import checkpoint

    ap = argparse.ArgumentParser()
    ap.add_argument("--at", type=int, default=16,
                    help="steps before the one compared")
    ap.add_argument("--worlds", type=int, default=cs.GS_W)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--perturb", default=None)
    ap.add_argument("--save", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("CUDA is not available", file=sys.stderr)
            return 2
        print(cs.card_line())
    card = torch.device(args.device)
    if card.type == "cuda":
        card = torch.device("cuda", torch.cuda.current_device())
    Compare, Route = make_modes(card, args.perturb)

    cfg = PhysicsConfig(solver="gauss_seidel", dt=1.0 / 60.0)
    ex, _, _ = cs.stack_scene(cfg, args.worlds, args.device)
    step = ex.step_fn()
    state = ex.state
    for _ in range(args.at):
        state = step(state, {})[0]
    worlds = list(cs.CHECK_WORLDS)
    card_fn = cs.stack_scene(cfg, len(worlds), args.device)[0].step_fn()
    cpu_fn = cs.stack_scene(cfg, len(worlds), "cpu")[0].step_fn()
    start = cs.world_slice(state, worlds, "cpu")
    if args.save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save)),
                    exist_ok=True)
        checkpoint.save_npz(args.save, start)
        print(f"saved the carried state of worlds {worlds} after {args.at} "
              f"steps to {args.save}")
    ref = cs.body_tree(cpu_fn(start, {})[0])

    def card_step(mode=None):
        s = cs.world_slice(state, worlds, args.device)
        if mode is None:
            return cs.body_tree(card_fn(s, {})[0])
        with mode:
            out = card_fn(s, {})[0]
        return cs.body_tree(out)

    def report(got):
        """(outside a golden bound?, text)."""
        worst = {k: float((got[k] - ref[k]).abs().max()) for k in cs.GOLDEN}
        off = cs.outside_golden(got, ref)
        cases = []
        for k, (mask, _) in off.items():
            d = (got[k] - ref[k]).abs().amax(-1)
            cases += [f"world {worlds[w_]} body {b_} {k} "
                      f"{float(d[w_, b_]):.6g}"
                      for w_, b_ in torch.nonzero(mask).tolist()]
        same = all(torch.equal(got[k], ref[k]) for k in got)
        text = ("bit-identical to the CPU" if same else "largest "
                + ", ".join(f"{k} {v:.4g}" for k, v in worst.items())
                + (f"; outside: {'; '.join(cases)}" if cases else ""))
        return bool(off), text

    print(f"[1] one step after {args.at} steps, card vs CPU: "
          f"{report(card_step())[1]}", flush=True)

    cmp = Compare()
    card_step(cmp)
    differ = {k: v for k, v in cmp.seen.items() if v[1]}
    print(f"[2] {sum(v[0] for v in cmp.seen.values())} op calls of "
          f"{len(cmp.seen)} names on the card; outputs that differ from the "
          f"CPU's on the same inputs:")
    for k, (n, nd, worst, src) in sorted(differ.items(),
                                         key=lambda kv: -kv[1][1]):
        print(f"    {k}: {nd} of {n} calls, largest {worst:.6g}, first at "
              f"{src}")
    names = set(differ)
    print(f"[3] all {len(names)} names on the CPU: "
          f"{report(card_step(Route(names)))[1]}", flush=True)
    alone = {}
    for k in sorted(names):
        breach, text = report(card_step(Route(names - {k})))
        alone[k] = breach
        print(f"    only {k} on the card: {text}", flush=True)

    for k in sorted(n for n, b in alone.items() if b):
        total = differ[k][0]
        lo, hi = 0, total
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if report(card_step(Route(names, k, (lo, mid))))[0]:
                hi = mid
            elif report(card_step(Route(names, k, (mid, hi))))[0]:
                lo = mid
            else:
                break
        log = []
        breach, text = report(card_step(Route(names, k, (lo, hi), log)))
        print(f"[4] {k}: calls [{lo}, {hi}) of {total} alone on the card: "
              f"{text}")
        for i, src, c_args, out, want in log:
            got_t, want_t = _tensors(out), _tensors(want)
            rows = [j for g, w in zip(got_t, want_t)
                    for j in [_bits_differ(g, w)] if bool(j.any())]
            if not rows and hi - lo > 1:
                continue
            print(f"    call {i} at {src}")
            for g, w in zip(got_t, want_t):
                d = _bits_differ(g, w)
                print(f"      output {tuple(g.shape)} {g.dtype}: "
                      f"{int(d.sum())} elements differ")
                flat = torch.nonzero(d).flatten()[:8].tolist()
                for e in flat:
                    print(f"        element {e}: card "
                              f"{float(g.reshape(-1)[e])!r} CPU "
                              f"{float(w.reshape(-1)[e])!r}")
                if flat and g.dim() >= 1 and g.shape[0] == len(worlds):
                    wi = flat[0] // max(g[0].numel(), 1)
                    for a in _tensors(c_args):
                        if a.dim() >= 1 and a.shape[0] == len(worlds):
                            print(f"        input {tuple(a.shape)} world "
                                  f"{worlds[wi]}: "
                                  f"{a[wi].reshape(-1)[:12].tolist()!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
