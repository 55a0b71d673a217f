from .runner import Runner  # noqa: F401
