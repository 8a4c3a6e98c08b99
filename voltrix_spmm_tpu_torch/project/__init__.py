from .const import *  # noqa: F401,F403
