"""Experiment and serving configurations of the port."""
from .paper_gp import GP_SERVE, GPServeConfig

__all__ = ["GP_SERVE", "GPServeConfig"]
