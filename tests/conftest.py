"""Test configuration.

Tests run on a simulated 8-device CPU mesh so multi-device sharding paths
are exercised without GPUs (SURVEY.md section 4: the reference never tests
multi-node because nothing is multi-node; we do). Set TPM_TEST_GPU=1 to run
against the real devices instead (``TPM_TEST_GPU=1 pytest -m gpu``).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# hermetic chooser: a machine-local calibration cache must not change what
# the suite's chooser-dependent assertions see (tests that WANT a custom
# calibration set TPM_COST_CONSTANTS themselves)
os.environ.setdefault("TPM_COST_CONSTANTS", "/nonexistent/tpm-cost-constants")

if not os.environ.get("TPM_TEST_GPU"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    # entry points turn on the persistent compile cache; the suite stays
    # hermetic and writes nothing into the checkout
    jax.config.update("jax_enable_compilation_cache", False)
