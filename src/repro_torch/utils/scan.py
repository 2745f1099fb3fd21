"""The port's counterpart of ``jax.lax.scan``: a loop over one axis of its
inputs that the step accounting can count without running every step.

``scan(step, carry, xs, consts=(), dim=1, loop="time")`` calls
``step(carry, x_t, *consts) -> (carry, y_t)`` for t = 0 .. n-1, ``x_t``
being the t-th slice along ``dim`` of every leaf of the tree ``xs`` (one
``unbind`` a leaf, so a backward stacks each leaf's gradients once), and
returns ``(carry, ys)``: ``ys`` the tree of the ``y_t``, each leaf stacked
along ``dim`` (a None leaf stays None). ``consts`` are the tensors the
step reads at every t (a sLSTM's recurrent matrices).

**Eager mode** is that loop. Serving and training only ever see it, so
their results are the loop's bit for bit, on the CPU and on the card.

**Rolled mode** engages only under a ``launch/step_analysis.py``
``StepCounter`` that rolls this kind of loop (``loop``: ``"time"`` for
the recurrences over a sequence, ``"layers"`` for a segment's blocks),
when it is the only counter in effect, when every tensor going in is a
``FakeTensor`` and when n > 3; a real tensor, on the CPU or on the card,
always runs the loop. It runs three steps, not n: the first and the last
as themselves, and the second in a scope of the counter that counts
everything it records n - 2 times, standing for the n - 2 middle steps.
The first and the last step are not the middle ones' equals: autograd
takes no gradient into the first step's carry (unless the carry wants
one) and gives none to the last step's carry from a next step, and a
sharded first step may redistribute an unsharded initial carry. The
middle steps are all alike. The backward is autograd's own through the
three steps: prehooks on their last nodes switch the counter's scope as
the engine reaches the middle step's nodes and leaves them (the engine
runs a later step's nodes before an earlier one's), so the gradients that
pile up in a tensor every step reads (``consts``) add n - 1 times. The
``unbind`` of ``xs`` and the ``stack`` of ``ys`` count as the loop's own
(one operation over n slices each way, with DTensor's moves of the slices
to one placement) without making the n slices; the stack's backward
selects n slices.

Temporary bytes follow the loop as far as a peak can see it. The middle
step stands for the last of the middle steps: of each buffer it
allocates that outlives the next step, n - 3 more copies are live from
its start (the loop keeps one a step), a ``y`` slice's until the stack
and a buffer's that autograd saves until the middle step's part of the
backward ends; of its gradient slices of ``xs``, n - 3 more from that
end until the unbind's stack. A carry that only the next step reads
counts once: the new carry replaces the old one. The count so sees the
live bytes of the loop's last two steps in the forward and of its last
middle step in the backward, where the loop's peaks lie as long as a
step saves more bytes than its gradient slices take (every loop of this
package): it equals the loop's, but for the sLSTM's backward, one carry
leaf under it.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_unflatten

# The step counters in effect, innermost last (``StepCounter`` enters and
# leaves itself here).
ACTIVE_COUNTERS: List[Any] = []


def scan(step: Callable, carry: Any, xs: Any, *, consts: Sequence = (),
         dim: int = 1, loop: str = "time") -> Tuple[Any, Any]:
    """``(carry, ys)`` of ``step`` over the slices of ``xs`` along ``dim``
    (see the module docstring)."""
    leaves = tree_leaves(xs)
    n = leaves[0].shape[dim]
    counter = _rolling_counter(loop, n, (carry, leaves, consts))
    if counter is not None:
        return _rolled(counter.roll(n), step, carry, xs, consts, dim)
    slices = [x.unbind(dim) for x in leaves]
    ys = []
    for t in range(n):
        carry, y = step(carry, tree_unflatten(xs, [s[t] for s in slices]),
                        *consts)
        ys.append(y)
    return carry, stack_trees(ys, dim)


def stack_trees(ys: List[Any], dim: int) -> Any:
    """The tree of ``ys[0]`` with every tensor leaf the leaves of all
    ``ys`` stacked along ``dim``."""
    cols = [tree_leaves(y) for y in ys]
    return tree_unflatten(ys[0], [torch.stack(list(c), dim)
                                  for c in zip(*cols)])


def _rolling_counter(loop: str, n: int, tree) -> Any:
    """The counter that rolls this loop, or None (run the loop)."""
    if n <= 3 or len(ACTIVE_COUNTERS) != 1 \
            or loop not in ACTIVE_COUNTERS[0].rolled:
        return None
    from torch._subclasses.fake_tensor import is_fake

    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and not is_fake(t):
            return None
    return ACTIVE_COUNTERS[0]


def _last_node(tree):
    """The node of ``tree``'s tensors that autograd recorded last (the
    first its backward runs), or None."""
    nodes = [t.grad_fn for t in tree_leaves(tree)
             if isinstance(t, torch.Tensor) and t.grad_fn is not None]
    return max(nodes, key=lambda g: g._sequence_nr(), default=None)


def _rolled(roll, step, carry, xs, consts, dim):
    """The first, a middle (counted n - 2 times) and the last step."""
    n = roll.n
    leaves = tree_leaves(xs)
    grad = torch.is_grad_enabled()
    if grad and any(x.requires_grad for x in leaves):
        parts = [_RolledUnbind.apply(roll, dim, x) for x in leaves]
    else:
        parts = [roll.unbind(x, dim) for x in leaves]

    def x_at(i):
        return tree_unflatten(xs, [p[i] for p in parts])

    ys = []
    carry, y = step(carry, x_at(0), *consts)
    ys.append(y)
    first = _last_node((carry, y))
    with roll.middle():
        carry, y = step(carry, x_at(1), *consts)
    ys.append(y)
    middle = _last_node((carry, y))
    carry, y = step(carry, x_at(2), *consts)
    ys.append(y)
    roll.next_step_done()
    last = _last_node((carry, y))
    if grad and None not in (first, middle, last) \
            and len({id(first), id(middle), id(last)}) == 3:
        roll.hook_backward(last, middle, first)
    cols = [tree_leaves(y) for y in ys]
    return carry, tree_unflatten(ys[0], [_stack_rolled(roll, c, dim)
                                         for c in zip(*cols)])


def _stack_rolled(roll, three, dim):
    if torch.is_grad_enabled() and any(y.requires_grad for y in three):
        return _RolledStack.apply(roll, dim, *three)
    return roll.stack(three, dim)


class _RolledStack(torch.autograd.Function):
    """The loop's ``stack`` of its n ``y`` slices (the middle one n - 2
    times); the backward selects n slices of the gradient, as the stack's
    own backward does, the middle one in the counter's n - 2 scope."""

    @staticmethod
    def forward(ctx, roll, dim, first, mid, last):
        ctx.roll, ctx.dim = roll, dim
        ctx.set_materialize_grads(False)
        return roll.stack((first, mid, last), dim)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None, None, None, None
        roll, dim = ctx.roll, ctx.dim
        first = g.select(dim, 0)
        with roll.times(roll.n - 2):
            mid = g.select(dim, 1)
        return None, None, first, mid, g.select(dim, roll.n - 1)


class _RolledUnbind(torch.autograd.Function):
    """The loop's ``unbind`` of a leaf of ``xs`` (its first, second and
    last slice); the backward stacks n gradients as the unbind's own
    backward does (zeros for a slice that got none), the second n - 2
    times, kept alive n - 2 times over until the stack."""

    @staticmethod
    def forward(ctx, roll, dim, x):
        ctx.roll, ctx.dim = roll, dim
        ctx.set_materialize_grads(False)
        first, mid, last = roll.unbind(x, dim)
        ctx.like = (first.dtype, first.device, first.shape)
        return first, mid, last

    @staticmethod
    def backward(ctx, first, mid, last):
        roll = ctx.roll
        dtype, device, shape = ctx.like

        def given(g, times=1):
            if g is not None:
                return g
            with roll.times(times):
                return torch.zeros((), dtype=dtype,
                                   device=device).expand(shape)

        first, last = given(first), given(last)
        mid = given(mid, roll.n - 2)
        roll.keep_middle_grad(mid)
        return None, None, roll.stack((first, mid, last), ctx.dim)
