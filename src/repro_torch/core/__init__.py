"""Core of the CT port: levels, the batched executor, interpolation."""
