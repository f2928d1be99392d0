from . import groups  # noqa: F401
from .mesh import MeshConfig  # noqa: F401
