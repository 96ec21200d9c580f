"""The paper's optimizer directions on the port (GP-H / GP-X)."""
from .gp_directions import (auto_lengthscale, gph_direction,
                            gph_direction_state, gpx_direction,
                            gpx_direction_state)

__all__ = ["auto_lengthscale", "gph_direction", "gph_direction_state",
           "gpx_direction", "gpx_direction_state"]
