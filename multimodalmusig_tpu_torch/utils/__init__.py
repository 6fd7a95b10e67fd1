from . import data, formatting  # noqa: F401
