"""The level driver and the public front door."""
