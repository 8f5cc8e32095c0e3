"""Launchers of the LM stack (serving so far)."""
