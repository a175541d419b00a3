"""Launchers: the serving launcher (single-engine mode)."""
