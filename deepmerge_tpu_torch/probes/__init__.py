"""Development probes of the port's kernels on the card (not on any path)."""
