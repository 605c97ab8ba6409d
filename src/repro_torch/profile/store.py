"""Persist, load, install and validate ``repro.profile/v1`` artifacts.

A copy of ``repro/profile/store.py`` for the port. It reads the
repository's committed artifacts under ``experiments/profiles/`` (the
default root) and never writes there: :func:`save_profile` writes only to
a path or a root that its caller names. The validator checks schema
shape, provenance legality and staleness. The messages are the
reference's word for word.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from repro_torch.core.profile import (
    MEASURED, PROFILE_SCHEMA, PUBLISHED, DeviceProfile, set_default_profile,
)

#: the repository's own profile artifacts, wherever the caller runs from
#: (the JAX package's root is relative to the working directory)
DEFAULT_ROOT = str(Path(__file__).resolve().parents[3] / "experiments"
                   / "profiles")


def path_for(device: str, root: str | None = None) -> str:
    return os.path.join(root or DEFAULT_ROOT, f"{device}.json")


def save_profile(prof: DeviceProfile, path: str | None = None, *,
                 root: str | None = None) -> str:
    """Write ``prof`` atomically (tmp + rename) to ``path``, or as
    ``<root>/<device>.json``. One of the two must be named: the port has
    no default destination."""
    if path is None:
        if root is None:
            raise ValueError("save_profile writes to a path or root that "
                             "the caller names; neither was given")
        path = path_for(prof.device, root)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(prof.to_json(), fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return path


def load_profile(device_or_path: str, root: str | None = None) -> DeviceProfile:
    """Load by artifact path, or by device name from the profile root."""
    path = (device_or_path if device_or_path.endswith(".json")
            else path_for(device_or_path, root))
    with open(path) as fh:
        return DeviceProfile.from_json(json.load(fh))


def install_profile(device_or_path: str, *,
                    require_kind: str = "tpu") -> DeviceProfile:
    """Launcher entry point: load, vet, and activate a profile.

    Wrong-kind and stale artifacts fail here, at startup, with the
    reference's message. Raises ``SystemExit``; returns the installed
    profile."""
    prof = load_profile(device_or_path)
    if require_kind and prof.kind != require_kind:
        raise SystemExit(
            f"profile {device_or_path} is kind={prof.kind!r} "
            f"({prof.device}); these consumers need a {require_kind}-family "
            f"profile (e.g. {path_for('tpu_v5e')})")
    stale = prof.is_stale()
    if stale:
        raise SystemExit(
            f"profile {device_or_path} is stale: {stale}; re-dissect with "
            f"`python -m repro.bench profile dissect {prof.device}`")
    set_default_profile(prof)
    return prof


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

_REQUIRED_KEYS = ("schema", "device", "kind", "engine_version",
                  "registry_hash", "caches", "latency",
                  "latency_provenance", "bandwidth", "spec",
                  "spec_provenance")


def validate_file(path: str) -> list[str]:
    """Problems with one artifact (empty list = valid + fresh)."""
    problems: list[str] = []
    try:
        with open(path) as fh:
            raw = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        return [f"unreadable: {e}"]
    if raw.get("schema") != PROFILE_SCHEMA:
        return [f"schema {raw.get('schema')!r} != {PROFILE_SCHEMA!r}"]
    for key in _REQUIRED_KEYS:
        if key not in raw:
            problems.append(f"missing required key {key!r}")
    if problems:
        return problems
    try:
        prof = DeviceProfile.from_json(raw)
    except (TypeError, ValueError) as e:
        return [f"malformed: {e}"]
    for sec_name, values, prov in (
            ("latency", prof.latency, prof.latency_provenance),
            ("bandwidth", prof.bandwidth, prof.bandwidth_provenance),
            ("spec", prof.spec, prof.spec_provenance)):
        missing = set(values) - set(prov)
        if missing:
            problems.append(
                f"{sec_name}: fields without provenance: {sorted(missing)}")
        bad = {k: v for k, v in prov.items() if v not in (MEASURED, PUBLISHED)}
        if bad:
            problems.append(f"{sec_name}: illegal provenance {bad}")
    base = os.path.splitext(os.path.basename(path))[0]
    if base != prof.device:
        problems.append(f"filename {base!r} != device {prof.device!r}")
    problems.extend(f"stale: {p}" for p in prof.is_stale())
    return problems


def validate_all(root: str | None = None) -> dict[str, list[str]]:
    """``{path: problems}`` for every ``*.json`` under the profile root
    (the committed one unless ``root`` is named)."""
    root = root or DEFAULT_ROOT
    out: dict[str, list[str]] = {}
    if not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        if name.endswith(".json"):
            path = os.path.join(root, name)
            out[path] = validate_file(path)
    return out
