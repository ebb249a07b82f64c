"""Label selectors and host-side matching.

The moral equivalent of apimachinery's labels.Selector / metav1.LabelSelector
(staging/src/k8s.io/apimachinery/pkg/labels, pkg/apis/meta/v1/types.go).
Selectors here are plain data with a canonical key so they can be interned
into the device-side selector vocabulary (see ops/encoding.py): per-node
match-count tensors are maintained per interned selector, which is how
InterPodAffinity / PodTopologySpread matching becomes integer gathers on TPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

# Operators (metav1.LabelSelectorOperator + node-selector extras)
OP_IN = "In"
OP_NOT_IN = "NotIn"
OP_EXISTS = "Exists"
OP_DOES_NOT_EXIST = "DoesNotExist"
OP_GT = "Gt"  # node-selector only
OP_LT = "Lt"  # node-selector only


@dataclass(frozen=True)
class Requirement:
    key: str
    operator: str
    values: Tuple[str, ...] = ()

    def matches(self, labels: Mapping[str, str]) -> bool:
        has = self.key in labels
        if self.operator == OP_IN:
            return has and labels[self.key] in self.values
        if self.operator == OP_NOT_IN:
            # metav1 semantics via LabelSelectorAsSelector: NotIn requires ...
            # labels.Selector semantics: NotIn matches if key absent OR value
            # not in set (apimachinery labels/selector.go Matches).
            return (not has) or labels[self.key] not in self.values
        if self.operator == OP_EXISTS:
            return has
        if self.operator == OP_DOES_NOT_EXIST:
            return not has
        if self.operator in (OP_GT, OP_LT):
            if not has:
                return False
            try:
                lv = int(labels[self.key])
                rv = int(self.values[0])
            except (ValueError, IndexError):
                return False
            return lv > rv if self.operator == OP_GT else lv < rv
        raise ValueError(f"unknown operator {self.operator!r}")


@dataclass(frozen=True)
class LabelSelector:
    """metav1.LabelSelector: AND of match_labels and match_expressions.

    An empty selector matches everything; None (no selector) matches nothing
    — callers encode that distinction themselves, mirroring
    LabelSelectorAsSelector.
    """

    match_labels: Tuple[Tuple[str, str], ...] = ()
    match_expressions: Tuple[Requirement, ...] = ()

    @classmethod
    def make(
        cls,
        match_labels: Optional[Mapping[str, str]] = None,
        match_expressions: Sequence[Requirement] = (),
    ) -> "LabelSelector":
        ml = tuple(sorted((match_labels or {}).items()))
        return cls(match_labels=ml, match_expressions=tuple(match_expressions))

    def matches(self, labels: Mapping[str, str]) -> bool:
        for k, v in self.match_labels:
            if labels.get(k) != v:
                return False
        for r in self.match_expressions:
            if not r.matches(labels):
                return False
        return True

    @property
    def is_empty(self) -> bool:
        return not self.match_labels and not self.match_expressions

    def canonical(self) -> Tuple:
        """Hashable canonical form used for selector interning."""
        return (
            self.match_labels,
            tuple(
                (r.key, r.operator, tuple(sorted(r.values)))
                for r in sorted(
                    self.match_expressions, key=lambda r: (r.key, r.operator)
                )
            ),
        )


def selector_from_match_labels(labels: Mapping[str, str]) -> LabelSelector:
    return LabelSelector.make(match_labels=dict(labels))


def labels_match_selector(
    labels: Mapping[str, str], selector: Optional[LabelSelector]
) -> bool:
    """None selector matches nothing (LabelSelectorAsSelector(nil))."""
    if selector is None:
        return False
    return selector.matches(labels)


def match_labels(selector: Mapping[str, str], labels: Mapping[str, str]) -> bool:
    """matchLabels subset semantics (labels.SelectorFromSet): EMPTY selector
    matches EVERYTHING — metav1.LabelSelector{} selects all pods, the
    convention PDBs and controllers rely on. Shared by the controllers and
    the preemptor so budget accounting and victim filtering can't diverge."""
    return all(labels.get(k) == val for k, val in selector.items())


# ---------------------------------------------------------------------------
# Selector-string parsing + field selectors (apimachinery pkg/labels
# Parse and pkg/fields): the ?labelSelector= / ?fieldSelector= list-option
# surface. Field selectors here are GENERIC dotted paths over the object
# (camelCase, as on the wire) — a superset of the reference's
# per-resource allowlists (spec.nodeName, status.phase, metadata.name...),
# so every reference-legal selector works.
# ---------------------------------------------------------------------------


def parse_label_selector(s: str) -> LabelSelector:
    """"a=b,c!=d,e,f in (x,y),!g" -> LabelSelector. ValueError on syntax
    errors (maps to 400 at the REST boundary)."""
    import re as _re

    labels = {}
    exprs = []
    s = (s or "").strip()
    # split on commas NOT inside parentheses
    terms = _re.split(r",(?![^(]*\))", s) if s else []
    for term in terms:
        term = term.strip()
        if not term:
            continue
        m = _re.match(r"^(\S+)\s+(in|notin)\s+\(([^)]*)\)$", term)
        if m:
            vals = tuple(v.strip() for v in m.group(3).split(",") if v.strip())
            op = OP_IN if m.group(2) == "in" else OP_NOT_IN
            exprs.append(Requirement(m.group(1), op, vals))
        elif "!=" in term:
            k, _, v = term.partition("!=")
            exprs.append(Requirement(k.strip(), OP_NOT_IN, (v.strip(),)))
        elif "==" in term or "=" in term:
            k, _, v = term.partition("==") if "==" in term else term.partition("=")
            k, v = k.strip(), v.strip()
            if not _re.match(r"^[\w.\-/]+$", k) or not _re.match(
                r"^[\w.\-]*$", v
            ):
                raise ValueError(f"bad label selector term {term!r}")
            labels[k] = v
        elif term.startswith("!"):
            exprs.append(Requirement(term[1:].strip(), OP_DOES_NOT_EXIST))
        elif _re.match(r"^[\w.\-/]+$", term):
            exprs.append(Requirement(term, OP_EXISTS))
        else:
            raise ValueError(f"bad label selector term {term!r}")
    return LabelSelector.make(match_labels=labels, match_expressions=exprs)


@dataclass(frozen=True)
class FieldSelector:
    """Parsed ?fieldSelector=: AND of (dotted path, op, value) terms with
    op '=' or '!='. Values compare as strings (fields.Set semantics)."""

    terms: Tuple[Tuple[str, str, str], ...] = ()

    @classmethod
    def parse(cls, s: str) -> "FieldSelector":
        terms = []
        for term in (s or "").split(","):
            term = term.strip()
            if not term:
                continue
            if "!=" in term:
                path, _, v = term.partition("!=")
                op = "!="
            elif "==" in term:
                path, _, v = term.partition("==")
                op = "="
            elif "=" in term:
                path, _, v = term.partition("=")
                op = "="
            else:
                raise ValueError(f"bad field selector term {term!r}")
            if not path.strip():
                raise ValueError(f"bad field selector term {term!r}")
            terms.append((path.strip(), op, v.strip()))
        return cls(terms=tuple(terms))

    @property
    def is_empty(self) -> bool:
        return not self.terms

    @staticmethod
    def _lookup(obj, path: str) -> str:
        from .serialization import _snake

        cur = obj
        for seg in path.split("."):
            if cur is None:
                return ""
            if isinstance(cur, Mapping):
                cur = cur.get(seg)
                continue
            cur = getattr(cur, _snake(seg), None)
        if cur is None or cur is False:
            return "" if cur is None else "false"
        if cur is True:
            return "true"
        return str(cur)

    def matches(self, obj) -> bool:
        for path, op, want in self.terms:
            got = self._lookup(obj, path)
            if op == "=" and got != want:
                return False
            if op == "!=" and got == want:
                return False
        return True
