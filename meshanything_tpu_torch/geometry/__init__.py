"""JAX-free host geometry for the port (copies of the numpy stage of
``meshanything_tpu/geometry``)."""
from meshanything_tpu_torch.geometry.normalize import (
    discretize,
    normalize_mesh_app,
    normalize_pc_cli,
    normalize_vertices,
    undiscretize,
)
from meshanything_tpu_torch.geometry.obj_io import (
    Mesh,
    detect_mesh_format,
    load_mesh,
    load_obj,
    load_ply,
    save_obj,
)
from meshanything_tpu_torch.geometry.postprocess import faces_to_mesh, postprocess_faces
from meshanything_tpu_torch.geometry.sample import sample_surface_torch, sample_surface_with_normals
