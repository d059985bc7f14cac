"""Reference input graphs for fitting."""
