"""The data pipeline (numpy only)."""
