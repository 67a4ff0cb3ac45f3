"""Inverse rendering: the train step (one device)."""
