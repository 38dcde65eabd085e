"""Device-resident DFA table.

The compiled automaton placed on device: the flat signed transition table
(replicated to every chip under a mesh — the reference replicates its
``d_trans`` buffer per worker thread, acsmx.c:618-666; here replication is a
``NamedSharding(P())`` annotation) plus the small per-state match side tables.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from pattern_matching.core.dfa import DfaTable


@dataclasses.dataclass
class DeviceTable:
    """DFA arrays on device + static metadata.

    ``table_flat[s * A + c]`` = next state, negated iff final (match).
    ``state_gid`` / ``group_rep`` resolve matched states to match groups and
    representative pattern indices after compaction (two tiny gathers over
    sparse results instead of the reference's full-width second table row,
    acsmx.c:648-651).
    """

    table_flat: jax.Array  # [S * A] int16 or int32
    state_gid: jax.Array  # [S] int32
    group_rep: jax.Array  # [G] int32
    alphabet_size: int
    max_pat_len: int
    num_states: int
    num_groups: int
    num_patterns: int

    @staticmethod
    def put(
        table: DfaTable,
        sharding: jax.sharding.Sharding | None = None,
    ) -> "DeviceTable":
        """Upload a compiled table (replicated when ``sharding`` given)."""
        flat = np.ascontiguousarray(table.goto_signed).reshape(-1)
        put = (
            (lambda x: jax.device_put(x, sharding))
            if sharding is not None
            else jax.device_put
        )
        return DeviceTable(
            table_flat=put(flat),
            state_gid=put(table.state_gid.astype(np.int32)),
            group_rep=put(table.group_rep.astype(np.int32)),
            alphabet_size=table.alphabet_size,
            max_pat_len=table.max_pat_len,
            num_states=table.num_states,
            num_groups=table.num_groups,
            num_patterns=table.num_patterns,
        )

    @property
    def nbytes(self) -> int:
        return self.table_flat.size * self.table_flat.dtype.itemsize
