"""Load and install ``repro.profile/v1`` artifacts.

A copy of the reading half of ``repro/profile/store.py`` for the port:
``load_profile``, ``install_profile`` and ``path_for``. The port reads
the repository's committed artifacts under ``experiments/profiles/`` and
never writes them; saving and validation stay with the JAX package,
which dissects. The messages are the reference's word for word.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from repro_torch.core.profile import DeviceProfile, set_default_profile

#: the repository's own profile artifacts, wherever the caller runs from
#: (the JAX package's root is relative to the working directory)
DEFAULT_ROOT = str(Path(__file__).resolve().parents[3] / "experiments"
                   / "profiles")


def path_for(device: str, root: str | None = None) -> str:
    return os.path.join(root or DEFAULT_ROOT, f"{device}.json")


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
