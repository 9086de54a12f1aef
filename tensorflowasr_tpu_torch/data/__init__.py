"""Host-side data pipeline of the port (numpy / scipy only)."""
