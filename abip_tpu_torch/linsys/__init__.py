"""Linear-system backends of the conic projection step."""
