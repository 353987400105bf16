"""Small helpers of the port (counterpart of `repro.utils`)."""
