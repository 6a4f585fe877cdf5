"""Port-specific utilities; artifact I/O is shared from ``plotweave.utils``."""
