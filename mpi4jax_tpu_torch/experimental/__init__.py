"""Experimental APIs: ``notoken``, the ops without tokens."""

from . import notoken  # noqa: F401
