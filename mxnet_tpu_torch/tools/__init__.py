"""Command-line tools of the port (parity: tools/ of the repo)."""
