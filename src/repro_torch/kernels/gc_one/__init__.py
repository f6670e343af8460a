"""One garbage collection of the simulator (group, victim, decision and
the drain, §5.6 demotion included) in one launch."""
