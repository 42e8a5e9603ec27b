"""Backward-chaining inference: goals + rules + axioms -> IDAG (Section 4.1).

The IDAG has concrete terms as vertices and rule applications (RAPs) as
edges; its RAP dual — kernel callsites as vertices, terms as edges — is the
paper's dataflow DAG (Fig. 2) and is built in :mod:`repro_torch.core.dataflow`.

Only one rule may produce a given term (the paper's single-producer
restriction); violating programs raise :class:`InferenceError`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .rules import Axiom, Goal, KernelRule, Program
from .terms import Term, UnifyError, unify_term

LOAD = "load"
STORE = "store"


class InferenceError(Exception):
    pass


@dataclass(frozen=True)
class RAP:
    """A rule application: one kernel callsite with concrete terms.

    ``kind`` is 'kernel' for real kernels and 'load' / 'store' for the
    pseudo-kernels handling terminal references (Fig. 2).
    """

    kind: str
    rule: KernelRule | None
    in_terms: tuple[Term, ...]
    out_terms: tuple[Term, ...]

    @property
    def name(self) -> str:
        if self.kind == "kernel":
            assert self.rule is not None
            return self.rule.name
        return self.kind

    def key(self):
        return (self.kind, self.name, self.in_terms, self.out_terms)

    def __str__(self) -> str:  # pragma: no cover
        ins = ", ".join(map(str, self.in_terms))
        outs = ", ".join(map(str, self.out_terms))
        return f"{self.name}({ins}) -> {outs}"


@dataclass
class IDAG:
    """Inference result: all RAPs plus producer/consumer maps over terms."""

    program: Program
    raps: list[RAP] = field(default_factory=list)
    producer: dict[Term, RAP] = field(default_factory=dict)
    consumers: dict[Term, list[RAP]] = field(default_factory=dict)
    axiom_of: dict[Term, Axiom] = field(default_factory=dict)
    goal_of: dict[Term, Goal] = field(default_factory=dict)

    def add_rap(self, rap: RAP) -> RAP:
        for existing in self.raps:
            if existing.key() == rap.key():
                return existing
        self.raps.append(rap)
        for t in rap.out_terms:
            if t in self.producer and self.producer[t].key() != rap.key():
                raise InferenceError(
                    f"term {t} produced by both {self.producer[t]} and {rap}"
                )
            self.producer[t] = rap
        for t in rap.in_terms:
            self.consumers.setdefault(t, []).append(rap)
        return rap


def _match_axiom(program: Program, term: Term) -> Axiom | None:
    hit = None
    for ax in program.axioms:
        try:
            unify_term(ax.term, term)
        except UnifyError:
            continue
        if hit is not None:
            raise InferenceError(f"term {term} matches multiple axioms")
        hit = ax
    return hit


def _match_rule(program: Program, term: Term) -> tuple[KernelRule, "RAP"] | None:
    hit: tuple[KernelRule, RAP] | None = None
    for rule in program.rules:
        for out in rule.outputs:
            try:
                b = unify_term(out.pattern, term)
            except UnifyError:
                continue
            try:
                in_terms = tuple(b.subst_term(p.pattern) for p in rule.inputs)
                out_terms = tuple(b.subst_term(p.pattern) for p in rule.outputs)
            except UnifyError as e:  # under-constrained rule
                raise InferenceError(
                    f"rule {rule.name} under-constrained for {term}: {e}"
                ) from e
            rap = RAP("kernel", rule, in_terms, out_terms)
            if hit is not None and hit[1].key() != rap.key():
                raise InferenceError(
                    f"term {term} derivable from multiple rules: "
                    f"{hit[0].name} and {rule.name}"
                )
            hit = (rule, rap)
    return hit


def infer(program: Program) -> IDAG:
    """Discover the dataflow needed to derive every goal from the axioms."""
    idag = IDAG(program)
    in_progress: set[Term] = set()
    done: set[Term] = set()

    def derive(term: Term) -> None:
        if term in done:
            return
        if term in in_progress:
            raise InferenceError(f"cyclic derivation through {term}")
        in_progress.add(term)
        try:
            ax = _match_axiom(program, term)
            hit = _match_rule(program, term)
            if ax is not None and hit is not None:
                raise InferenceError(
                    f"term {term} is both an axiom and derivable via {hit[0].name}"
                )
            if ax is not None:
                idag.axiom_of[term] = ax
                idag.add_rap(RAP(LOAD, None, (), (term,)))
            elif hit is not None:
                _, rap = hit
                rap = idag.add_rap(rap)
                for t in rap.in_terms:
                    derive(t)
            else:
                raise InferenceError(f"no axiom or rule derives required term {term}")
        finally:
            in_progress.discard(term)
        done.add(term)

    for g in program.goals:
        derive(g.term)
        idag.goal_of[g.term] = g
        idag.add_rap(RAP(STORE, None, (g.term,), ()))
    return idag
