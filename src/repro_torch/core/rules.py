"""Kernel production rules and program descriptions (HFAV front-end).

A :class:`KernelRule` is the Python equivalent of one ``kernels:`` entry in
the paper's YAML front-end (Fig. 10): a name, input term patterns, output
term patterns, and — because our backend emits JAX rather than C — a jnp
callable implementing the kernel body.  The callable receives one array (or
scalar) per input parameter, in declaration order, and returns one value per
output parameter.  Kernel bodies must be pure (no side effects, Section 3.1)
and element-wise over the vectorized dimension; reduction kernels must be
associative (Section 3.4).

A :class:`Program` is the equivalent of the ``globals:`` section: axioms
(available inputs with iteration-space extents), goals (required outputs),
plus the global loop order.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from .terms import Term, parse_term


@dataclass(frozen=True)
class Param:
    """One kernel parameter: local name + term pattern."""

    name: str
    pattern: Term


@dataclass(frozen=True)
class KernelRule:
    """A production rule describing one kernel and its data dependencies."""

    name: str
    inputs: tuple[Param, ...]
    outputs: tuple[Param, ...]
    fn: Optional[Callable] = None
    # 'map' kernels are pure functions of their inputs; 'reduce' kernels
    # combine data into an accumulator with an associative operator whose
    # identity is ``init`` — the engine synthesizes the paper's
    # init/accumulate/finalize *triple* (Section 3.4): identity
    # initialization lands in the prologue, the combine in the steady
    # state, and any user finalize kernel fuses into the epilogue through
    # the ordinary rank rules.
    kind: str = "map"
    init: float = 0.0
    # a reduction's region: ``(dim, Extent)`` pairs narrowing what it
    # folds in those reduced dims (by default everything its input can
    # provide), e.g. the interior of a grid whose frame holds ghosts
    within: tuple = ()

    def __post_init__(self) -> None:
        if not self.outputs:
            raise ValueError(f"kernel {self.name} has no outputs")
        if self.within and not self.is_reduction:
            raise ValueError(f"kernel {self.name}: only a reduction "
                             f"takes a region (within=)")

    @property
    def is_reduction(self) -> bool:
        if self.kind == "reduce":
            return True
        out_dims = {d for p in self.outputs for d in p.pattern.dims}
        in_dims = {d for p in self.inputs for d in p.pattern.dims}
        return bool(in_dims - out_dims)

    @property
    def is_broadcast(self) -> bool:
        out_dims = {d for p in self.outputs for d in p.pattern.dims}
        in_dims = {d for p in self.inputs for d in p.pattern.dims}
        return bool(out_dims - in_dims) and bool(self.inputs)


def kernel(
    name: str,
    inputs: Sequence[tuple[str, str]],
    outputs: Sequence[tuple[str, str]],
    fn: Optional[Callable] = None,
    kind: str = "map",
    init: float = 0.0,
    within: Optional[dict] = None,
) -> KernelRule:
    """Convenience constructor parsing pattern strings; ``within`` maps a
    reduced dim to its region as :func:`axiom` takes extents."""
    return KernelRule(
        name=name,
        inputs=tuple(Param(n, parse_term(p)) for n, p in inputs),
        outputs=tuple(Param(n, parse_term(p)) for n, p in outputs),
        fn=fn,
        kind=kind,
        init=init,
        within=tuple(sorted(_extents(within or {}).items())),
    )


@dataclass(frozen=True)
class Extent:
    """Closed-open interval ``[lo_off, size + hi_off)`` for one dimension.

    ``size`` is the name of the runtime extent symbol (e.g. ``"Nj"``); the
    integer offsets allow halo widening during inference (the Minkowski-sum
    footnote of Section 3.5).
    """

    size: str
    lo: int = 0
    hi: int = 0

    def widen(self, off: int) -> "Extent":
        return Extent(self.size, min(self.lo, self.lo + off), max(self.hi, self.hi + off))

    def union(self, other: "Extent") -> "Extent":
        assert self.size == other.size
        return Extent(self.size, min(self.lo, other.lo), max(self.hi, other.hi))

    def __str__(self) -> str:  # pragma: no cover
        return f"[{self.lo:+d}, {self.size}{self.hi:+d})"


@dataclass
class Axiom:
    """A terminal input term with per-dimension extents."""

    term: Term
    extents: dict[str, Extent] = field(default_factory=dict)


@dataclass
class Goal:
    """A terminal output term with per-dimension extents."""

    term: Term
    extents: dict[str, Extent] = field(default_factory=dict)
    # Name of the external array the goal is stored to (defaults to a
    # mangled form of the term).  Used for in/out alias chaining.
    store_as: Optional[str] = None


@dataclass
class Program:
    """Axioms + goals + rules + the user-selected global loop order.

    ``loop_order`` lists iteration identifiers outermost-first, e.g.
    ``("j", "i")``; rank(i) = 0 is innermost (Section 3.3.2).  The innermost
    identifier is the vectorized dimension in both backends.
    ``aliases`` lists (input name, output name) pairs that share storage
    (Section 3.5, in/out chaining).
    """

    rules: list[KernelRule]
    axioms: list[Axiom]
    goals: list[Goal]
    loop_order: tuple[str, ...]
    aliases: list[tuple[str, str]] = field(default_factory=list)
    name: str = "program"

    def rank(self, dim: str) -> int:
        # rank 0 == innermost == last entry of loop_order
        return len(self.loop_order) - 1 - self.loop_order.index(dim)

    def order_dims(self, dims: Sequence[str]) -> tuple[str, ...]:
        """Sort ``dims`` outermost-first according to the global loop order."""
        return tuple(sorted(dims, key=self.loop_order.index))


def _extents(extents: dict) -> dict[str, Extent]:
    exts: dict[str, Extent] = {}
    for d, e in extents.items():
        if isinstance(e, Extent):
            exts[d] = e
        elif isinstance(e, str):
            exts[d] = Extent(e)
        else:
            exts[d] = Extent(*e)
    return exts


def axiom(term: str, **extents: Extent | tuple | str) -> Axiom:
    """An input term; with no extents (and no indices), a scalar."""
    return Axiom(parse_term(term), _extents(extents))


def goal(term: str, store_as: Optional[str] = None, **extents) -> Goal:
    return Goal(parse_term(term), _extents(extents), store_as)
