"""Graph file parsing."""
