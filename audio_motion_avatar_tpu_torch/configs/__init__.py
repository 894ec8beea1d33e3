from .loader import Config, ConfigLoader  # noqa: F401
