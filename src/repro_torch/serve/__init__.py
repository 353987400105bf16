"""Serving of the port (counterpart of `repro.serve`): the
continuous-batching engine over replica groups."""
