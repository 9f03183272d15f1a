"""Type vocabulary and id codec."""
