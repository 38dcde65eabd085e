from pattern_matching.ops.table import DeviceTable  # noqa: F401
from pattern_matching.ops.match_xla import scan_batch, ScanResult  # noqa: F401
from pattern_matching.ops.compact import compact_matches  # noqa: F401
