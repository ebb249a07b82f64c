"""Device data plane: columnar snapshot encoding, template batches, the
wave kernel and the hand-written CUDA fit-mask kernel."""

from .encoding import (  # noqa: F401
    EncodingConfig,
    SnapshotEncoder,
    DeviceSnapshot,
    PodBatch,
    Vocab,
)
