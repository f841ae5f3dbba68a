"""Command-line entry points of the port, and the meshes (`mesh`) and
allocation-free specs (`specs`) the distribution layer places by."""
