"""repro_torch.data — deterministic step-indexed pipelines (synthetic +
object-store-backed via the straggler-aware scheduler), batches on the
card.  Counterpart of the JAX package's ``data``."""

from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig, ObjectStoreTokens, SyntheticTokens,
)
