"""Array utilities."""

from .compact import compact_valid  # noqa: F401
