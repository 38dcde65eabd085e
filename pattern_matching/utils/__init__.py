from pattern_matching.utils.common import (  # noqa: F401
    cdiv,
    roundup,
    hex_to_bytes,
    now_us,
)
