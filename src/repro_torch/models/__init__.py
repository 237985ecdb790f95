"""Model building blocks of the port (so far: blockwise flash attention)."""
