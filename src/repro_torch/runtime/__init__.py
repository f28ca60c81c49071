"""Runtime policy of the CT port: fault recombination, health tracking
and the durable tenant store."""
