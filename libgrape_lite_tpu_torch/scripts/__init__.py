"""Command-line tools of the port that are not graph apps."""
