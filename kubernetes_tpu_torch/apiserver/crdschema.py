"""CRD versions + OpenAPI-v3 structural-schema validation.

The apiextensions-apiserver's per-version serving and validation role
(reference staging/src/k8s.io/apiextensions-apiserver/pkg/apiserver/
validation/validation.go and customresource_handler.go): a CRD may
declare multiple versions, each served or not, exactly one marked
`storage`; custom-resource writes are validated against the request
version's schema and persisted at the storage version ("None"
conversion strategy — only the apiVersion field is rewritten, which is
all this single-internal-version build needs).

CRD spec.versions accepts both shorthand strings ("v1" — served,
first entry is storage) and objects
{name, served, storage, schema: {openAPIV3Schema: {...}}}, mirroring
the reference's v1beta1 `version` shorthand vs v1 `versions` list.

The schema validator covers the structural subset the reference
enforces most: type, properties, required, items, enum, minimum/
maximum, minLength/maxLength, minItems/maxItems, pattern,
additionalProperties (false or schema). `x-kubernetes-*` extensions
are accepted and ignored.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

from ..api.validation import ValidationError
from ..client.apiserver import NotFound

_TYPE_CHECKS = {
    "object": lambda v: isinstance(v, dict),
    "array": lambda v: isinstance(v, list),
    "string": lambda v: isinstance(v, str),
    "integer": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "number": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool),
    "boolean": lambda v: isinstance(v, bool),
}


def normalize_versions(crd) -> List[Dict[str, Any]]:
    """spec.versions (strings or dicts) -> [{name, served, storage,
    schema}]. Exactly one storage version: explicit flags win; with pure
    shorthand the FIRST entry is storage (deterministic, documented)."""
    out: List[Dict[str, Any]] = []
    raw = list(getattr(crd.spec, "versions", None) or [])
    for entry in raw:
        if isinstance(entry, str):
            out.append(
                {"name": entry, "served": True, "storage": False, "schema": None}
            )
        elif isinstance(entry, dict):
            schema = (entry.get("schema") or {}).get("openAPIV3Schema") or None
            out.append(
                {
                    "name": entry.get("name", ""),
                    "served": bool(entry.get("served", True)),
                    "storage": bool(entry.get("storage", False)),
                    "schema": schema,
                }
            )
    if out and not any(v["storage"] for v in out):
        out[0]["storage"] = True
    return out


def version_entry(crd, version: str) -> Optional[Dict[str, Any]]:
    for v in normalize_versions(crd):
        if v["name"] == version:
            return v
    return None


def storage_api_version(crd) -> str:
    vs = normalize_versions(crd)
    name = next((v["name"] for v in vs if v["storage"]), "v1")
    group = crd.spec.group
    return f"{group}/{name}" if group else name


def validate_schema(value: Any, schema: Dict[str, Any], path: str = "") -> List[str]:
    """Value vs OpenAPI-v3 subset; returns human-readable violations."""
    errs: List[str] = []
    where = path or "<root>"
    t = schema.get("type")
    if t:
        check = _TYPE_CHECKS.get(t)
        if check is None:
            errs.append(f"{where}: unknown schema type {t!r}")
            return errs
        if not check(value):
            errs.append(
                f"{where}: expected {t}, got {type(value).__name__}"
            )
            return errs
    if "enum" in schema and value not in schema["enum"]:
        errs.append(f"{where}: {value!r} not in enum {schema['enum']}")
    if isinstance(value, str):
        if "minLength" in schema and len(value) < schema["minLength"]:
            errs.append(f"{where}: shorter than minLength {schema['minLength']}")
        if "maxLength" in schema and len(value) > schema["maxLength"]:
            errs.append(f"{where}: longer than maxLength {schema['maxLength']}")
        if "pattern" in schema and not re.search(schema["pattern"], value):
            errs.append(f"{where}: does not match pattern {schema['pattern']!r}")
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        if "minimum" in schema and value < schema["minimum"]:
            errs.append(f"{where}: {value} < minimum {schema['minimum']}")
        if "maximum" in schema and value > schema["maximum"]:
            errs.append(f"{where}: {value} > maximum {schema['maximum']}")
    if isinstance(value, list):
        if "minItems" in schema and len(value) < schema["minItems"]:
            errs.append(f"{where}: fewer than minItems {schema['minItems']}")
        if "maxItems" in schema and len(value) > schema["maxItems"]:
            errs.append(f"{where}: more than maxItems {schema['maxItems']}")
        items = schema.get("items")
        if items:
            for idx, item in enumerate(value):
                errs.extend(validate_schema(item, items, f"{path}[{idx}]"))
    if isinstance(value, dict):
        props = schema.get("properties") or {}
        for k, sub in props.items():
            if k in value:
                errs.extend(
                    validate_schema(value[k], sub, f"{path}.{k}" if path else k)
                )
        for k in schema.get("required", []):
            if k not in value:
                errs.append(f"{where}: missing required property {k!r}")
        addl = schema.get("additionalProperties", True)
        if addl is False:
            for k in value:
                if k not in props:
                    errs.append(f"{where}: unknown property {k!r}")
        elif isinstance(addl, dict):
            for k, v in value.items():
                if k not in props:
                    errs.extend(
                        validate_schema(v, addl, f"{path}.{k}" if path else k)
                    )
    return errs


def find_crd(store, resource: str, group: Optional[str]):
    """The established CRD claiming (group, plural), or None."""
    try:
        crds, _ = store.list("customresourcedefinitions")
    except Exception:
        return None
    for c in crds:
        if c.spec.names.plural != resource:
            continue
        if group is None or c.spec.group == group:
            return c
    return None


def check_cr_write(crd, version: Optional[str], body: dict) -> str:
    """Gate one custom-resource write: the request version must be
    served, and the non-metadata content must satisfy that version's
    schema. Returns the storage apiVersion to persist at. Raises
    ValidationError (HTTP 400) on violation, NotFound (404) for an
    unserved/unknown version."""
    ver = version
    if ver is None:
        # core-path writes (/api/v1/<plural>) carry the version in the
        # body's apiVersion, if any
        av = body.get("apiVersion", "")
        ver = av.rsplit("/", 1)[-1] if av else None
    if ver is not None:
        entry = version_entry(crd, ver)
        if entry is None or not entry["served"]:
            raise NotFound(
                f"version {ver!r} of {crd.spec.names.plural} is not served"
            )
        schema = entry["schema"]
    else:
        # versionless shorthand write: validate against the storage schema
        vs = normalize_versions(crd)
        entry = next((v for v in vs if v["storage"]), None)
        schema = entry["schema"] if entry else None
    if schema:
        content = {
            k: v
            for k, v in body.items()
            if k not in ("metadata", "kind", "apiVersion")
        }
        errs = validate_schema(content, schema)
        if errs:
            raise ValidationError(
                f"{crd.spec.names.kind or crd.spec.names.plural} invalid: "
                + "; ".join(errs[:8])
            )
    return storage_api_version(crd)
