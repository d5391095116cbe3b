"""Experimental APIs: ``notoken``, the ops without tokens."""
