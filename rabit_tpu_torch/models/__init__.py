"""Models built on the port's ops."""
