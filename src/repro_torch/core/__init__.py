"""Core of the CT port: levels, the batched executor, interpolation, the
per-grid hierarchization facade, the heat solver and the iterated
combination technique."""
