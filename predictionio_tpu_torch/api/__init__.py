"""REST plumbing of the port (the Event Server waits for its slice)."""
