"""Process grids, communicators and routing specs."""
