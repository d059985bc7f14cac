"""Feature-table schema and mode-specific normalization."""
