"""Runtime of the CT port: fault recombination, health tracking, the
durable tenant store, the multi-host cluster and elastic re-spreading."""
