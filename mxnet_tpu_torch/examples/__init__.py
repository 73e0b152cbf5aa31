"""Port-side copies of the repo's example models (parity: examples/)."""
