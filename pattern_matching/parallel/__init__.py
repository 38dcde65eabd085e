from pattern_matching.parallel.mesh import (  # noqa: F401
    MeshContext,
    make_mesh,
    init_distributed,
)
