"""Runtime policy of the CT port: fault recombination and health tracking."""
