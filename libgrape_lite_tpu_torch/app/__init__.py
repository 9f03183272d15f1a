"""The PIE app framework."""
