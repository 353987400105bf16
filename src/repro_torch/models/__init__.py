"""Model stack of the port (counterpart of `repro.models`): configs,
parameters, the dense attention layers and the stage-stacked forward."""
