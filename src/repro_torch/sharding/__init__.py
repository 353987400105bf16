"""Fleet-scale backend of the simulator (port of `repro.sharding.sim`)."""
