"""Host utilities of the port (the frame checksum)."""
