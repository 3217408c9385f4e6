"""Modem chains of the port."""
