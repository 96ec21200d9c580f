"""Serving steps of the port."""
from .serve import GPServeBundle, build_gp_serve_step

__all__ = ["GPServeBundle", "build_gp_serve_step"]
