"""Caption metrics (pure Python)."""
