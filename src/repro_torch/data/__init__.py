"""Synthetic LM data of the port."""
