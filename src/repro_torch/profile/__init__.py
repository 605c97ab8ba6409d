"""Device profiles for the port: the ported part of ``repro.profile``.

Only the artifact store is ported (:mod:`.store`: load, vet and install
a committed ``repro.profile/v1`` artifact). The blind dissection
pipeline and the diff table wait for the simulator backends (ROADMAP.md,
queue 1). The :class:`~repro_torch.core.profile.DeviceProfile` dataclass
lives in ``repro_torch.core.profile``, as in the JAX package.
"""

from repro_torch.core.profile import (      # noqa: F401  (re-exports)
    PROFILE_SCHEMA, CacheProfile, DeviceProfile, SpecMixWarning,
    registry_fingerprint, resolve_spec, set_default_profile, use_profile,
)
from repro_torch.profile.store import (     # noqa: F401
    DEFAULT_ROOT, install_profile, load_profile, path_for,
)
