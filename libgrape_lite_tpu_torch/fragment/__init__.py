"""Edge-cut fragments and the graph loader."""
