"""Architecture configs of the port (counterpart of `repro.configs`): the
dense attention-only models and mamba2-1.3b, selectable through
`registry`, with the runtime plans (`runtime`) and input shapes
(`shapes`) of their train and serve steps."""
