"""Models built on the port: the shallow-water solver."""
