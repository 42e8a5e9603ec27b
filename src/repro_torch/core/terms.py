"""Terms, references and unification for the HFAV inference front-end.

The paper's declarative front-end describes kernels with *term patterns*
such as ``q?[j?-1][i?]`` (inputs) and ``laplace(q?[j?][i?])`` (outputs).
Names suffixed with ``?`` are pattern variables; array indices are a
dimension variable plus an integer displacement.  Unification binds name
variables to concrete names and dimension variables to a *shifted*
concrete dimension (``j? -> j+1``), which gives the translation-invariant
("canonical frame of reference") semantics of Section 3.1.

Grammar accepted by :func:`parse_term`::

    term := NAME '(' term ')' | ref
    ref  := NAME ('[' idx ']')*
    idx  := DIM (('+'|'-') INT)?

Names/dims ending in '?' are pattern variables.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional


_IDX_RE = re.compile(r"^\s*([A-Za-z_][A-Za-z0-9_]*\??)\s*(?:([+-])\s*(\d+))?\s*$")
_REF_RE = re.compile(r"^\s*([A-Za-z_][A-Za-z0-9_]*\??)\s*((?:\[[^\]]*\])*)\s*$")


def _is_var(name: str) -> bool:
    return name.endswith("?")


@dataclass(frozen=True, order=True)
class Index:
    """A single array index: dimension name (or variable) + displacement."""

    dim: str
    off: int = 0

    @property
    def is_var(self) -> bool:
        return _is_var(self.dim)

    def shift(self, delta: int) -> "Index":
        return Index(self.dim, self.off + delta)

    def __str__(self) -> str:  # pragma: no cover - repr convenience
        if self.off == 0:
            return self.dim
        return f"{self.dim}{'+' if self.off > 0 else '-'}{abs(self.off)}"


@dataclass(frozen=True, order=True)
class Ref:
    """An array reference ``name[idx0][idx1]...`` (possibly 0-dim)."""

    name: str
    indices: tuple[Index, ...] = ()

    @property
    def is_var(self) -> bool:
        return _is_var(self.name)

    @property
    def dims(self) -> tuple[str, ...]:
        return tuple(ix.dim for ix in self.indices)

    @property
    def offsets(self) -> tuple[int, ...]:
        return tuple(ix.off for ix in self.indices)

    def __str__(self) -> str:  # pragma: no cover
        return self.name + "".join(f"[{ix}]" for ix in self.indices)


@dataclass(frozen=True, order=True)
class Term:
    """A (possibly functor-wrapped) reference.

    ``laplace(cell[j][i])`` has ``functors=('laplace',)`` and the inner
    :class:`Ref`.  A bare reference has no functors.  Functor nesting deeper
    than a chain is not needed by the paper's front-end.
    """

    ref: Ref
    functors: tuple[str, ...] = ()

    @property
    def dims(self) -> tuple[str, ...]:
        return self.ref.dims

    @property
    def offsets(self) -> tuple[int, ...]:
        return self.ref.offsets

    def base(self) -> "Term":
        """The same term with all displacements zeroed (the callsite group key)."""
        ref = Ref(self.ref.name, tuple(Index(ix.dim, 0) for ix in self.ref.indices))
        return Term(ref, self.functors)

    def shift(self, deltas: dict[str, int]) -> "Term":
        ref = Ref(
            self.ref.name,
            tuple(ix.shift(deltas.get(ix.dim, 0)) for ix in self.ref.indices),
        )
        return Term(ref, self.functors)

    def __str__(self) -> str:  # pragma: no cover
        s = str(self.ref)
        for f in reversed(self.functors):
            s = f"{f}({s})"
        return s


def parse_index(text: str) -> Index:
    m = _IDX_RE.match(text)
    if not m:
        raise ValueError(f"bad index {text!r}")
    dim, sign, off = m.groups()
    o = int(off) if off else 0
    if sign == "-":
        o = -o
    return Index(dim, o)


def parse_ref(text: str) -> Ref:
    m = _REF_RE.match(text)
    if not m:
        raise ValueError(f"bad reference {text!r}")
    name, idx_blob = m.groups()
    indices = tuple(parse_index(t) for t in re.findall(r"\[([^\]]*)\]", idx_blob))
    return Ref(name, indices)


def parse_term(text: str) -> Term:
    text = text.strip()
    functors: list[str] = []
    while True:
        m = re.match(r"^([A-Za-z_][A-Za-z0-9_]*\??)\s*\((.*)\)\s*$", text)
        if m and "[" not in m.group(1):
            functors.append(m.group(1))
            text = m.group(2)
        else:
            break
    return Term(parse_ref(text), tuple(functors))


class UnifyError(Exception):
    pass


@dataclass
class Bindings:
    """Substitution produced by unification.

    * ``names``: pattern name var -> concrete name (for array names and
      functors).
    * ``dims``: pattern dim var -> (concrete dim, shift).  A pattern index
      ``j?-1`` matched against concrete ``j+0`` binds ``j? -> (j, +1)`` so
      that substituting elsewhere gives ``j?+0 -> j+1``.
    """

    names: dict[str, str]
    dims: dict[str, Index]

    def copy(self) -> "Bindings":
        return Bindings(dict(self.names), dict(self.dims))

    def subst_index(self, ix: Index) -> Index:
        if ix.is_var:
            if ix.dim not in self.dims:
                raise UnifyError(f"unbound dim var {ix.dim}")
            b = self.dims[ix.dim]
            return Index(b.dim, b.off + ix.off)
        return ix

    def subst_ref(self, ref: Ref) -> Ref:
        name = self.names.get(ref.name, ref.name) if ref.is_var else ref.name
        if _is_var(name):
            raise UnifyError(f"unbound name var {ref.name}")
        return Ref(name, tuple(self.subst_index(ix) for ix in ref.indices))

    def subst_term(self, term: Term) -> Term:
        functors = tuple(
            (self.names.get(f, f) if _is_var(f) else f) for f in term.functors
        )
        for f in functors:
            if _is_var(f):
                raise UnifyError(f"unbound functor var {f}")
        return Term(self.subst_ref(term.ref), functors)


def unify_term(pattern: Term, concrete: Term, bindings: Optional[Bindings] = None) -> Bindings:
    """Unify ``pattern`` (may contain vars) against a var-free ``concrete``."""
    b = bindings.copy() if bindings is not None else Bindings({}, {})
    if len(pattern.functors) != len(concrete.functors):
        raise UnifyError(f"functor arity mismatch: {pattern} vs {concrete}")
    for pf, cf in zip(pattern.functors, concrete.functors):
        if _is_var(pf):
            if b.names.setdefault(pf, cf) != cf:
                raise UnifyError(f"functor var {pf} rebind {b.names[pf]} vs {cf}")
        elif pf != cf:
            raise UnifyError(f"functor mismatch {pf} vs {cf}")
    pr, cr = pattern.ref, concrete.ref
    if pr.is_var:
        if b.names.setdefault(pr.name, cr.name) != cr.name:
            raise UnifyError(f"name var {pr.name} rebind")
    elif pr.name != cr.name:
        raise UnifyError(f"name mismatch {pr.name} vs {cr.name}")
    if len(pr.indices) != len(cr.indices):
        raise UnifyError(f"rank mismatch {pattern} vs {concrete}")
    for pix, cix in zip(pr.indices, cr.indices):
        if pix.is_var:
            # pix.dim + pix.off == cix  =>  pix.dim -> cix - pix.off
            want = Index(cix.dim, cix.off - pix.off)
            got = b.dims.setdefault(pix.dim, want)
            if got != want:
                raise UnifyError(f"dim var {pix.dim}: {got} vs {want}")
        else:
            if pix != cix:
                raise UnifyError(f"index mismatch {pix} vs {cix}")
    return b
