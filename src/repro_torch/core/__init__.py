"""Host-side protocol model of the port (``protocol``)."""
