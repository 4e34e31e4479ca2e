from .sharding import make_render_mesh, render_frame_sharded  # noqa: F401
