"""Fragment <-> device topology."""
