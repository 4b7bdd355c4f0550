"""Process groups and meshes for the port's multi-process paths."""
