"""Architecture configs of the port (counterpart of `repro.configs`): the
four dense attention-only models, selectable through `registry`."""
