"""Label model: source-qualified key/value labels and label sets.

Semantics follow the reference's label model (reference: pkg/labels/labels.go,
pkg/labels/array.go): a label is (source, key, value); string form is
``source:key=value``; ``$x`` and ``reserved:x`` are reserved-source
shorthands; selectors use the "extended key" form ``source.key`` and an
``any``-source label matches any source.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Iterable, Iterator

PATH_DELIMITER = "."

# Special ID names (reference: pkg/labels/labels.go:31-57).
ID_NAME_ALL = "all"
ID_NAME_HOST = "host"
ID_NAME_WORLD = "world"
ID_NAME_CLUSTER = "cluster"
ID_NAME_HEALTH = "health"
ID_NAME_INIT = "init"
ID_NAME_UNMANAGED = "unmanaged"
ID_NAME_UNKNOWN = "unknown"

# Label sources (reference: pkg/labels/filter.go / labels.go).
SOURCE_UNSPEC = "unspec"
SOURCE_ANY = "any"
SOURCE_K8S = "k8s"
SOURCE_CONTAINER = "container"
SOURCE_RESERVED = "reserved"
SOURCE_CILIUM_GENERATED = "cilium-generated"

RESERVED_KEY_PREFIX = SOURCE_RESERVED + ":"


def parse_source(s: str) -> tuple[str, str]:
    """Split ``source:rest`` (also handling the ``$`` reserved shorthand).

    Mirrors the reference's parseSource (pkg/labels/labels.go:595-614).
    """
    if not s:
        return "", ""
    if s[0] == "$":
        return SOURCE_RESERVED, s[1:]
    i = s.find(":")
    if i < 0:
        if s.startswith(RESERVED_KEY_PREFIX):
            return SOURCE_RESERVED, s[len(RESERVED_KEY_PREFIX):]
        return "", s
    return s[:i], s[i + 1:]


@dataclass(frozen=True)
class Label:
    key: str
    value: str = ""
    source: str = SOURCE_UNSPEC

    @staticmethod
    def new(key: str, value: str = "", source: str = "") -> "Label":
        """Create a label, resolving an embedded source prefix in ``key``
        (reference: pkg/labels/labels.go:303-324)."""
        src, key = parse_source(key)
        if not source:
            source = src if src else SOURCE_UNSPEC
        if src == SOURCE_RESERVED and key == "":
            key, value = value, ""
        return Label(key=key, value=value, source=source)

    @property
    def extended_key(self) -> str:
        return self.source + PATH_DELIMITER + self.key

    def is_all_label(self) -> bool:
        return self.source == SOURCE_RESERVED and self.key == ID_NAME_ALL

    def is_any_source(self) -> bool:
        return self.source == SOURCE_ANY

    def is_reserved_source(self) -> bool:
        return self.source == SOURCE_RESERVED

    def is_valid(self) -> bool:
        return self.key != ""

    def equals(self, other: "Label") -> bool:
        """Source-aware equality: an ``any``-source label matches any source
        (reference: pkg/labels/labels.go:326-334)."""
        if not self.is_any_source() and self.source != other.source:
            return False
        return self.key == other.key and self.value == other.value

    def matches(self, target: "Label") -> bool:
        return self.is_all_label() or self.equals(target)

    def __str__(self) -> str:
        if self.value:
            return f"{self.source}:{self.key}={self.value}"
        return f"{self.source}:{self.key}"


def parse_label(s: str) -> Label:
    """Parse ``[source:]key[=value]`` (reference: pkg/labels/labels.go:615)."""
    src, rest = parse_source(s)
    source = src if src else SOURCE_UNSPEC
    i = rest.find("=")
    if i < 0:
        return Label(key=rest, source=source)
    if i == 0 and src == SOURCE_RESERVED:
        return Label(key=rest[1:], source=source)
    return Label(key=rest[:i], value=rest[i + 1:], source=source)


def parse_select_label(s: str) -> Label:
    """Like parse_label but unspecified source defaults to ``any``
    (reference: pkg/labels/labels.go:641)."""
    lbl = parse_label(s)
    if lbl.source == SOURCE_UNSPEC:
        return Label(key=lbl.key, value=lbl.value, source=SOURCE_ANY)
    return lbl


def get_extended_key_from(s: str) -> str:
    """``k8s:foo=bar`` -> ``k8s.foo``; bare keys get the ``any`` source
    (reference: pkg/labels/labels.go:438-455)."""
    src, rest = parse_source(s)
    if not src:
        src = SOURCE_ANY
    i = rest.find("=")
    if i >= 0:
        rest = rest[:i]
    return src + PATH_DELIMITER + rest


def get_cilium_key_from(ext_key: str) -> str:
    """``k8s.foo`` -> ``k8s:foo`` (reference: pkg/labels/labels.go:425)."""
    i = ext_key.find(PATH_DELIMITER)
    if i >= 0:
        return ext_key[:i] + ":" + ext_key[i + 1:]
    return SOURCE_ANY + ":" + ext_key


class LabelArray(tuple):
    """An ordered set of labels (reference: pkg/labels/array.go:18)."""

    def __new__(cls, labels: Iterable[Label] = ()):
        return super().__new__(cls, tuple(labels))

    @staticmethod
    def parse(*strs: str) -> "LabelArray":
        return LabelArray(parse_label(s) for s in strs)

    @staticmethod
    def parse_select(*strs: str) -> "LabelArray":
        return LabelArray(parse_select_label(s) for s in strs)

    def contains(self, needed: "LabelArray") -> bool:
        """True if every needed label matches one of ours
        (reference: pkg/labels/array.go:57-71)."""
        return all(any(n.matches(l) for l in self) for n in needed)

    def lacks(self, needed: "LabelArray") -> "LabelArray":
        return LabelArray(
            n for n in needed if not any(n.matches(l) for l in self)
        )

    def has(self, ext_key: str) -> bool:
        """Key lookup by extended key; ``any.key`` matches any source
        (reference: pkg/labels/array.go:96-131)."""
        any_prefix = SOURCE_ANY + PATH_DELIMITER
        for l in self:
            if l.extended_key == ext_key:
                return True
            if ext_key.startswith(any_prefix) and l.key == ext_key[len(any_prefix):]:
                return True
        return False

    def get(self, ext_key: str) -> str | None:
        any_prefix = SOURCE_ANY + PATH_DELIMITER
        for l in self:
            if l.extended_key == ext_key:
                return l.value
            if ext_key.startswith(any_prefix) and l.key == ext_key[len(any_prefix):]:
                return l.value
        return None

    def sort(self) -> "LabelArray":
        return LabelArray(sorted(self, key=lambda l: (l.source, l.key, l.value)))

    def get_model(self) -> list[str]:
        return [str(l) for l in self]

    def __repr__(self) -> str:
        return f"LabelArray({', '.join(str(l) for l in self)})"


class Labels(dict):
    """Map of key -> Label (reference: pkg/labels/labels.go Labels)."""

    @staticmethod
    def from_model(strs: Iterable[str]) -> "Labels":
        l = Labels()
        for s in strs:
            lbl = parse_label(s)
            if lbl.is_valid():
                l[lbl.key] = lbl
        return l

    @staticmethod
    def from_map(m: dict[str, str], source: str) -> "Labels":
        l = Labels()
        for k, v in m.items():
            lbl = Label.new(k, v, source)
            l[lbl.key] = lbl
        return l

    def upsert(self, lbl: Label) -> None:
        self[lbl.key] = lbl

    def merge(self, other: "Labels") -> None:
        self.update(other)

    def get_from_source(self, source: str) -> "Labels":
        out = Labels()
        for k, v in self.items():
            if v.source == source:
                out[k] = v
        return out

    def to_array(self) -> LabelArray:
        return LabelArray(self[k] for k in sorted(self))

    def sorted_list(self) -> bytes:
        """Canonical serialized form, input to the identity hash
        (reference: pkg/labels/labels.go:541)."""
        return b"".join(
            f"{l.source}:{l.key}={l.value};".encode()
            for l in (self[k] for k in sorted(self))
        )

    def sha256_sum(self) -> str:
        return hashlib.sha256(self.sorted_list()).hexdigest()

    def get_model(self) -> list[str]:
        return [str(self[k]) for k in sorted(self)]

    def equals(self, other: "Labels") -> bool:
        if len(self) != len(other):
            return False
        for k, v in self.items():
            o = other.get(k)
            if o is None or v.source != o.source or v.value != o.value:
                return False
        return True


# Reserved-label singletons.
LABEL_HOST = Label(key=ID_NAME_HOST, source=SOURCE_RESERVED)
LABEL_WORLD = Label(key=ID_NAME_WORLD, source=SOURCE_RESERVED)
LABEL_HEALTH = Label(key=ID_NAME_HEALTH, source=SOURCE_RESERVED)
LABEL_INIT = Label(key=ID_NAME_INIT, source=SOURCE_RESERVED)
LABEL_UNMANAGED = Label(key=ID_NAME_UNMANAGED, source=SOURCE_RESERVED)
LABEL_ALL = Label(key=ID_NAME_ALL, source=SOURCE_RESERVED)
