"""The live-caption demo of the port: `app` (one stream), `multiapp` (N lanes on one
card), `render` (caption bubbles burned into an mp4)."""

from .app import LiveCaptionServer, stream_segments  # noqa: F401
