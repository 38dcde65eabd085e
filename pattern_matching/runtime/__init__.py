from pattern_matching.runtime.buffers import DataBuffer, HostBatch  # noqa: F401
from pattern_matching.runtime.files import (  # noqa: F401
    expand_paths,
    get_all_regular_files,
)
