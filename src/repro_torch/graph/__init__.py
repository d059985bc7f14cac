"""Graph substrate and structural node features."""
