"""One garbage collection of the simulator (group, victim, decision and,
under the static detector, the drain) in one launch."""
