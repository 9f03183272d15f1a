"""The superstep driver."""
