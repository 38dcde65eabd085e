"""Native stager vs NumPy ingest parity (valid regions identical)."""

import io
import os

import numpy as np
import pytest

import pattern_matching.runtime.buffers as bufmod
from pattern_matching.runtime.buffers import DataBuffer, StreamState

stager_native = pytest.importorskip(
    "pattern_matching.runtime.stager_native", reason="g++ unavailable"
)
if not stager_native.available():
    pytest.skip("native stager build failed", allow_module_level=True)


def ingest(path, use_native, C=16, B=64, H=16):
    old = os.environ.pop("TPM_NO_NATIVE_STAGER", None)
    bufmod._STAGER_OK = None
    if not use_native:
        os.environ["TPM_NO_NATIVE_STAGER"] = "1"
    try:
        buf = DataBuffer(C, B, H)
        stream = StreamState(file_id=7)
        batches = []
        with open(path, "rb") as f:
            while True:
                code, rd = buf.add_stream(f, stream)
                if rd == 0:
                    break
                if code == -1:
                    batches.append(
                        (
                            buf.data.copy(),
                            buf.start_t.copy(),
                            buf.end_t.copy(),
                            buf.base_off.copy(),
                            buf.chunks,
                        )
                    )
                    buf.reset()
        batches.append(
            (
                buf.data.copy(),
                buf.start_t.copy(),
                buf.end_t.copy(),
                buf.base_off.copy(),
                buf.chunks,
            )
        )
        return batches, stream
    finally:
        os.environ.pop("TPM_NO_NATIVE_STAGER", None)
        if old:
            os.environ["TPM_NO_NATIVE_STAGER"] = old
        bufmod._STAGER_OK = None


@pytest.mark.parametrize("size", [0, 10, 64, 100, 64 * 16, 64 * 16 * 3 + 17])
def test_parity_with_numpy_path(tmp_path, size):
    p = tmp_path / "d.bin"
    p.write_bytes(np.random.RandomState(size or 1).bytes(size))
    nat, s1 = ingest(str(p), True)
    pyt, s2 = ingest(str(p), False)
    assert len(nat) == len(pyt)
    assert s1.offset == s2.offset and s1.tail == s2.tail
    for (d1, st1, e1, o1, c1), (d2, st2, e2, o2, c2) in zip(nat, pyt):
        assert c1 == c2
        assert np.array_equal(st1[:c1], st2[:c1])
        assert np.array_equal(e1[:c1], e2[:c1])
        assert np.array_equal(o1[:c1], o2[:c1])
        for i in range(c1):
            assert np.array_equal(d1[i, st1[i] : e1[i]], d2[i, st2[i] : e2[i]])


def test_matches_identical_both_paths(tmp_path):
    from pattern_matching.core.dfa import compile_patterns
    from pattern_matching.runtime.session import MatchSession

    patterns = [b"abcdefgh"]
    data = (b"x" * 60 + b"abcdefgh") * 30
    p = tmp_path / "d.bin"
    p.write_bytes(data)

    def find(native):
        old = os.environ.pop("TPM_NO_NATIVE_STAGER", None)
        bufmod._STAGER_OK = None
        if not native:
            os.environ["TPM_NO_NATIVE_STAGER"] = "1"
        try:
            sess = MatchSession(
                compile_patterns(patterns), max_chunks=8, chunk_len=64
            )
            out = []
            with open(p, "rb") as f:
                for bm in sess.scan_stream(f):
                    for ev in bm.events:
                        out.extend(ev.expand())
            return sorted(out)
        finally:
            os.environ.pop("TPM_NO_NATIVE_STAGER", None)
            if old:
                os.environ["TPM_NO_NATIVE_STAGER"] = old
            bufmod._STAGER_OK = None

    a, b = find(True), find(False)
    assert a == b
    assert len(a) == 30
