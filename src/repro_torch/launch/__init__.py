"""Device meshes for the port (``repro.launch``'s counterpart)."""
from repro_torch.launch.mesh import (DeviceMesh, as_mesh, make_mesh, with_model_axis,
                                     make_production_mesh)

__all__ = ["DeviceMesh", "make_mesh", "make_production_mesh", "as_mesh",
           "with_model_axis"]
