"""Measurement scripts run on the card, outside the serving path."""
