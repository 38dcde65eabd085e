"""C++ oracle conformance: must agree with the Python oracles and with the
device engine — three independent implementations cross-checked."""

import numpy as np
import pytest

from pattern_matching.core.dfa import compile_patterns
from pattern_matching.core.oracle import match_naive, match_python
from pattern_matching.runtime.session import MatchSession
from tests.fixtures import planted_binary

oracle_native = pytest.importorskip(
    "pattern_matching.core.oracle_native", reason="g++ unavailable"
)
try:
    oracle_native._lib()
except oracle_native.OracleUnavailable:
    pytest.skip("native oracle build failed", allow_module_level=True)

NativeOracle = oracle_native.NativeOracle


def test_agrees_with_python_oracles():
    cases = [
        ([b"he", b"she", b"his", b"hers"], b"ushers and his"),
        ([b"aa"], b"aaaa"),
        ([b"abc", b"abcdef", b"cde"], b"xabcdefy"),
        ([b"dup", b"dup"], b"a dup and a dup"),
    ]
    for patterns, data in cases:
        got = NativeOracle(patterns).match_events(data)
        assert got == sorted(match_naive(patterns, data))
        assert got == sorted(match_python(patterns, data))


def test_streaming_state_carry():
    patterns = [b"abcdef"]
    o = NativeOracle(patterns)
    ev1 = o.match(b"xxabc", 0)
    ev2 = o.match(b"defyy", 5)
    offs = ev1[0].tolist() + ev2[0].tolist()
    assert offs == [7]  # match ends at absolute offset 7


def test_ushort_alphabet():
    patterns = [(40, 32, 287), (5, 5)]
    data = [40, 32, 287, 5, 5, 5]
    got = NativeOracle(patterns, alphabet=2048).match_events(
        np.asarray(data, np.int32)
    )
    assert got == sorted(match_naive(patterns, data))


def test_corpus_scale_vs_device_engine():
    rng = np.random.RandomState(4)
    patterns = [
        bytes(rng.randint(0, 256, size=rng.randint(4, 16)).astype(np.uint8))
        for _ in range(200)
    ]
    data, _ = planted_binary(99, 1 << 16, patterns, 120)
    native = NativeOracle(patterns).match_events(data)
    sess = MatchSession(compile_patterns(patterns), max_chunks=32, chunk_len=512)
    assert sess.find(data) == native


def test_capacity_overflow_reports_total():
    o = NativeOracle([b"a"])
    off, pid, total = o.match(b"a" * 100, cap=10)
    assert total == 100
    assert len(off) == 10
