"""Scheduling core of the port: the locality model, the policy registry,
Balanced-PANDAS and the simulator entry point (fleet path only so far)."""
