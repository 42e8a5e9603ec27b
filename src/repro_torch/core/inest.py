"""Iteration nests (Section 3.2.1).

An :class:`INest` owns one loop identifier and three *phases* — prologue
(before the loop), steady state (the loop body) and epilogue (after the
loop).  Phases hold child nodes: nested :class:`INest`\\ s or leaf
:class:`Body` nodes carrying grouped kernel callsites.  A 'perfect' nest has
empty prologue/epilogue at every level and corresponds directly to an
iteration space.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Union

from .dataflow import Group
from .rules import Extent, Program

Node = Union["Body", "INest"]


@dataclass
class Body:
    """Leaf: an ordered list of grouped-callsite gids executed point-wise."""

    gids: list[int] = field(default_factory=list)

    def groups(self) -> set[int]:
        return set(self.gids)

    def pretty(self, by_id: dict[int, Group], indent: str = "") -> str:
        return "\n".join(f"{indent}{by_id[g]}" for g in self.gids)


@dataclass
class INest:
    """One loop level with prologue / steady-state / epilogue phases."""

    ident: str
    extent: Extent
    prologue: list[Node] = field(default_factory=list)
    steady: list[Node] = field(default_factory=list)
    epilogue: list[Node] = field(default_factory=list)

    def groups(self) -> set[int]:
        out: set[int] = set()
        for ph in (self.prologue, self.steady, self.epilogue):
            for n in ph:
                out |= n.groups()
        return out

    def phase_groups(self, phase: str) -> set[int]:
        out: set[int] = set()
        for n in getattr(self, phase):
            out |= n.groups()
        return out

    def prlg_only(self) -> set[int]:
        return self.phase_groups("prologue") - self.phase_groups("steady")

    def eplg_only(self) -> set[int]:
        return self.phase_groups("epilogue") - self.phase_groups("steady")

    def depth(self) -> int:
        d = 0
        for ph in (self.prologue, self.steady, self.epilogue):
            for n in ph:
                if isinstance(n, INest):
                    d = max(d, n.depth())
        return d + 1

    def pretty(self, by_id: dict[int, Group], indent: str = "") -> str:
        lines = [f"{indent}for {self.ident} in {self.extent}:"]
        for label, ph in (
            ("prologue", self.prologue),
            ("steady", self.steady),
            ("epilogue", self.epilogue),
        ):
            if ph:
                lines.append(f"{indent}  <{label}>")
                for n in ph:
                    lines.append(n.pretty(by_id, indent + "    "))
        return "\n".join(lines)


def irank(node: Node, program: Program) -> int:
    """Rank of the outermost identifier; leaf bodies rank below any loop."""
    if isinstance(node, Body):
        return -1
    return program.rank(node.ident)


def walk_bodies(node: Node) -> Iterator[Body]:
    if isinstance(node, Body):
        yield node
        return
    for ph in (node.prologue, node.steady, node.epilogue):
        for child in ph:
            yield from walk_bodies(child)


def perfect_nest(group: Group, program: Program) -> Node:
    """Build the initial perfect iteration nest for one grouped callsite."""
    node: Node = Body([group.gid])
    for dim in reversed(group.dims):  # innermost wraps first
        ext = group.extent.get(dim)
        if ext is None:
            ext = Extent(f"N{dim}")
        node = INest(dim, ext, steady=[node])
    return node
