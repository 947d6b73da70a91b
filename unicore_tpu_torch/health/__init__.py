"""Training-health sentinel (counterpart of ``unicore_tpu/health/``):
loss-spike detection with an in-memory rewind and a data skip-ahead.

- :mod:`~unicore_tpu_torch.health.detectors` — streaming anomaly detectors
  (EMA-band loss spikes, grad-norm explosion, loss-scale collapse);
- :mod:`~unicore_tpu_torch.health.snapshot` — device->host state copies
  into pinned buffers on a side stream, and the bounded rewind ring;
- :mod:`~unicore_tpu_torch.health.sentinel` — the recovery policy (the
  escalation ladder, the checkpointed event history).
"""

from unicore_tpu_torch.health.detectors import (  # noqa: F401
    Anomaly,
    GradNormExplosionDetector,
    LossScaleCollapseDetector,
    LossSpikeDetector,
)
from unicore_tpu_torch.health.sentinel import (  # noqa: F401
    ConsistencyError,
    TrainingHealthError,
    TrainingHealthSentinel,
    build_sentinel,
)
from unicore_tpu_torch.health.snapshot import (  # noqa: F401
    HealthSnapshot,
    SnapshotRing,
    device_restore_tree,
    host_copy_tree,
)
