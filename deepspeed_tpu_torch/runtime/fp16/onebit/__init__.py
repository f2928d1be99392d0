from .adam import OnebitAdam  # noqa: F401
from .lamb import OnebitLamb  # noqa: F401
from .zoadam import ZeroOneAdam  # noqa: F401
