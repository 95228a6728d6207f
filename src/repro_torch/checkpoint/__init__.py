"""repro_torch.checkpoint — sharded atomic checkpoints written through the
paper's straggler-aware I/O scheduler, snapshotted from the card and
restored onto it.  Counterpart of the JAX package's ``checkpoint``."""

from repro_torch.checkpoint.manifest import (  # noqa: F401
    LeafEntry, Manifest, ShardEntry, committed_steps, flatten_with_paths,
    load_manifest, unflatten_like,
)
from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    CheckpointConfig, Checkpointer,
)
