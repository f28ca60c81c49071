"""User-facing entry points of the CT port."""
