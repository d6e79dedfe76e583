"""Request arrivals for the port (copied from `repro.serving_plane`)."""
from .arrivals import ARRIVAL_KINDS, ArrivalProcess  # noqa: F401
