"""Baselines of the port: LiveCC (`livecc.LiveCCInfer`)."""

from . import livecc  # noqa: F401
