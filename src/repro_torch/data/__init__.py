"""Input pipeline of the port (counterpart of `repro.data`): the
locality-aware, deterministic chunk reader that feeds the trainer."""
