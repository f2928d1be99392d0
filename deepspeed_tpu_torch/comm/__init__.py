from .comm import *  # noqa: F401,F403
from .comm import __all__  # noqa: F401
