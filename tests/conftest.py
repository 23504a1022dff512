import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# Tests must see the real (1-device) CPU platform — the 512-device override
# belongs to the dry-run subprocesses only.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# Hermetic tuning: never read or write a developer's real tuning cache.
# Tests that exercise the cache opt in by monkeypatching this variable.
os.environ.setdefault("REPRO_TUNING_CACHE", "off")

# CI-pinned hypothesis profile: bound example counts globally so property
# suites can't silently creep the tier-1 runtime (per-test @settings with
# tighter explicit caps still win).  Select with HYPOTHESIS_PROFILE; "ci"
# is the default everywhere.
try:
    from hypothesis import settings as _hyp_settings

    _hyp_settings.register_profile("ci", max_examples=25, deadline=None)
    _hyp_settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "ci"))
except ImportError:  # property suites importorskip hypothesis themselves
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: hypothesis-heavy or subprocess-spawning suite; the fast "
        'tier-1 lane deselects these with -m "not slow" (CI still runs '
        "the full suite)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and the CUDA toolkit (the port's "
        "hand-written kernels); skips with a reason elsewhere")
