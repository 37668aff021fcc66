"""Launch substrate of the port: worker meshes (``launch.mesh``).
``repro_torch.core`` never imports this package."""
