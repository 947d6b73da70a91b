"""Measurement tools of the port, run by hand on a machine with a card."""
