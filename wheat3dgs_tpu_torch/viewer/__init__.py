from .server import ViewerState, serve  # noqa: F401
