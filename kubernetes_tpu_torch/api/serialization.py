"""The one helper the port's selectors take from the reference's
``api/serialization.py``: ``_snake`` (camelCase field path -> snake_case
attribute). The rest of the reference module (dict/JSON codecs) is not
on the port's path yet."""

from __future__ import annotations


def _snake(name: str) -> str:
    out = []
    for ch in name:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)
