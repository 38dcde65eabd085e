"""Exact multi-pattern string matching on an accelerator.

A from-scratch JAX/XLA framework with the capabilities of the OpenCL
Aho-Corasick grep in gvasilious/gpu_pattern_matching (see SURVEY.md):

- ``core``     — Aho-Corasick DFA compiler (byte and ushort alphabets), pattern
                 file parsing (text / hex / categorical / metadata-signature
                 formats), CPU oracles (Python + C++) for conformance.
- ``ops``      — device scan engines: the q-gram bloom filter probe
                 (candidates verified exactly on the host or the device)
                 and the ``lax.scan`` DFA walk; match
                 compaction (cumsum + scatter), sorting (``jax.lax.sort``).
- ``runtime``  — streaming buffer manager (fixed-shape chunk batches with
                 prefix halos), threaded file feeder with double buffering,
                 batched native match verification, stream-continuity
                 tracking, directory traversal, stats.
- ``parallel`` — device mesh construction and shardings: DFA table replicated,
                 corpus lanes data-parallel, per-pattern counts via psum.
- ``apps``     — sentiment analysis on the library API.
- ``cli``      — ``aho_grep``, mirroring the reference CLI flag surface.
"""

__version__ = "0.1.0"

from pattern_matching.core.dfa import (  # noqa: F401
    AhoCorasick,
    DfaTable,
    compile_patterns,
)
