"""The deterministic, resumable token pipeline (numpy only)."""
