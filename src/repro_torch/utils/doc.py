"""Docstring introspection shared by the self-describing registries
(`core.policy`, `workloads.scenario`); a copy of `repro.utils.doc`."""

from __future__ import annotations

from typing import Any


def first_doc_line(obj: Any) -> str:
    """First period-terminated sentence (or line) of `obj`'s docstring,
    whitespace-collapsed; empty string when undocumented."""
    doc = (obj.__doc__ or "").strip()
    if not doc:
        return ""
    head = doc.split(". ", 1)[0].split(".\n", 1)[0]
    return " ".join(head.split()).rstrip(".") + "."
