"""Atomic keep-k checkpoints in the reference's file layout."""
