"""The TGAR compute pattern, the Sum stage and the host view path."""
