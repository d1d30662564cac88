"""Distribution: the mesh of ranks and its collectives (``mesh``), and the
(data, spatial) sharded forward (``spatial``)."""
from masterthesis_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    init_distributed,
    make_mesh,
    make_mesh_2d,
    replicate,
)
