from aladin_torch.parallel.mesh import create_mesh, parse_mesh_shape  # noqa: F401
