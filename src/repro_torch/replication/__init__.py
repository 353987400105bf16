"""Replication lifecycle of the port (counterpart of `repro.replication`):
migration, adaptive replication, and failure/recovery as first-class
actions on both substrates.

See `repro_torch.replication.lifecycle` for the controller contract and
the `MigrationModel`, `repro_torch.replication.controllers` for the
built-ins (``fixed`` / ``repair`` / ``popularity``),
`repro_torch.replication.simproj` for the fixed-shape machinery of the
dense simulator's slot loop, and `repro_torch.replication.host` for the
serving engine's mirror.
"""

from repro_torch.replication.lifecycle import (  # noqa: F401
    MigrationModel,
    ReplicationConfig,
    ReplicationController,
    ReplicationLike,
    available_replications,
    get_replication_cls,
    make_replication,
    register_replication,
    replication_descriptions,
)
from repro_torch.replication.host import HostReplication  # noqa: F401
