"""Device profiles for the port: a copy of ``repro.profile``.

``pipeline.dissect_device`` runs the blind-recovery suite against a
registered device (engine ``vector``, ``reference`` or the batched
``torch`` engine on a named device); ``store`` loads, vets, installs,
validates and, to a path the caller names, saves ``repro.profile/v1``
artifacts; ``diffing`` renders the measured-vs-published verdict table.
The :class:`~repro_torch.core.profile.DeviceProfile` dataclass lives in
``repro_torch.core.profile``, as in the JAX package.
"""

from repro_torch.core.profile import (      # noqa: F401  (re-exports)
    PROFILE_SCHEMA, CacheProfile, DeviceProfile, SpecMixWarning,
    registry_fingerprint, resolve_spec, set_default_profile, use_profile,
)
from repro_torch.profile.diffing import (   # noqa: F401
    DiffRow, diff_profiles, render_diff,
)
from repro_torch.profile.pipeline import (  # noqa: F401
    dissect_device, published_profile,
)
from repro_torch.profile.store import (     # noqa: F401
    DEFAULT_ROOT, install_profile, load_profile, path_for, save_profile,
    validate_all, validate_file,
)
