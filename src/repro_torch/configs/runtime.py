"""Per-(arch x shape) runtime plans of the port (counterpart of
`repro.configs.runtime`): the memory knobs of a train or serve step.

The defaults follow the reference's memory policy:
  - the >=100B archs (jamba, mixtral) keep optimizer moments (and jamba's
    grad-accumulator) in bf16 and use deep microbatching (8; every other
    model takes 4 microbatches);
  - every model trains with per-block rematerialization.

`plan_for` gives the reference's ``microbatches``, ``accum_dtype``,
``opt`` and ``remat`` for every config.  The reference's plan also
carries a `ShardingPolicy` (FSDP over the data axes, KV-cache sequence
sharding for long_500k), ``pin_gathers`` (FSDP gathers kept inside the
layer scan) and the mesh's data axes: none of them has a meaning on one
card (ROADMAP Queue 1 item 12), so the port's `RuntimePlan` leaves them
out.  ``max_len`` (the decode cache length, read by `build_prefill_step`)
stays 0 here, as in the reference: a prefill then sizes its caches by
its own sequence length.
"""

from __future__ import annotations

from repro_torch.launch.steps import RuntimePlan
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig

_BIG = ("jamba-1.5-large-398b", "mixtral-8x22b")


def plan_for(cfg: ModelConfig, shape_name: str, kind: str) -> RuntimePlan:
    big = cfg.name in _BIG
    moment_dtype = "bfloat16" if big else "float32"
    accum_dtype = "bfloat16" if cfg.name == _BIG[0] else "float32"

    if kind == "train":
        micro = {"jamba-1.5-large-398b": 8, "mixtral-8x22b": 8}.get(
            cfg.name, 4)
        return RuntimePlan(
            microbatches=micro,
            accum_dtype=accum_dtype,
            opt=AdamWConfig(moment_dtype=moment_dtype,
                            update_dtype=("bfloat16" if big
                                          else "float32")),
            remat=True)

    return RuntimePlan(
        microbatches=1,
        opt=AdamWConfig(moment_dtype=moment_dtype),
        remat=(kind == "prefill"))
