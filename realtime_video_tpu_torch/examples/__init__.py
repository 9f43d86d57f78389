"""Example entry points of the port (offline generation, video-to-video)."""
