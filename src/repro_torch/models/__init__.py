"""Model code of the port: layers, the dense transformer, the registry."""
