"""Debug-logging subsystem (the reference's DPRINTF family, common.h:22-43)."""

import logging

import numpy as np


def test_dprint_levels(monkeypatch, caplog):
    from pattern_matching.utils import debug

    monkeypatch.delenv("TPM_DEBUG", raising=False)
    with caplog.at_level(logging.DEBUG, logger="pattern_matching"):
        debug.dprint(1, "should not appear")
    assert "should not appear" not in caplog.text

    monkeypatch.setenv("TPM_DEBUG", "1")
    with caplog.at_level(logging.DEBUG, logger="pattern_matching"):
        debug.dprint(1, "tier1 %d", 42)
        debug.dprint(2, "tier2 hidden")
    assert "tier1 42" in caplog.text
    assert "tier2 hidden" not in caplog.text


def test_framework_events_logged(monkeypatch, caplog):
    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.runtime.session import MatchSession

    monkeypatch.setenv("TPM_DEBUG", "1")
    with caplog.at_level(logging.DEBUG, logger="pattern_matching"):
        MatchSession(compile_patterns([b"abcd"]), max_chunks=2,
                     chunk_len=64, engine="bloom")
    assert "bloom build:" in caplog.text
    assert "session: engine=bloom" in caplog.text


def test_kernel_debug_prints_from_jit(monkeypatch, capfd):
    import jax
    import jax.numpy as jnp

    from pattern_matching.utils import debug

    monkeypatch.setenv("TPM_DEBUG", "2")

    @jax.jit
    def f(x):
        debug.kernel_debug("kernel value {}", jnp.sum(x))
        return x + 1

    jax.block_until_ready(f(jnp.ones(4)))
    jax.effects_barrier()
    assert "kernel value" in capfd.readouterr().out + capfd.readouterr().err
