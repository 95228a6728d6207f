"""repro_torch.io — object-storage substrate: striping, simulated/local
stores with redirect tables + metadata maintainer, and the client-side
scheduler client (paper Fig. 5).  Counterpart of the JAX package's
``io``; it runs on the host by design and touches no device."""

from repro_torch.io import striping  # noqa: F401
from repro_torch.io.striping import (  # noqa: F401
    MB, ObjectRequest, StripingConfig, object_id_for, stripe_file,
    stripe_request,
)
from repro_torch.io.objectstore import (  # noqa: F401
    LocalFSStore, MaintainerThread, ObjectMissingError, RedirectTable,
    ServerFailedError, SimulatedCluster, WriteResult,
)
from repro_torch.io.client import IOClient, IOClientConfig, WriteRecord  # noqa: F401
