"""Durable checkpoints (counterpart of ``unicore_tpu/checkpoint/``), used
through :mod:`unicore_tpu_torch.checkpoint_utils`:

* :mod:`~unicore_tpu_torch.checkpoint.format` — format v2: a header and a
  chunked CRC32 manifest around the ``torch.save`` payload, verified
  before it is loaded;
* :mod:`~unicore_tpu_torch.checkpoint.durable` — fsync of the staged file
  and its directory, atomic publishes, the ENOSPC preflight, read-back
  verification and the ``--on-save-failure`` ladder;
* :mod:`~unicore_tpu_torch.checkpoint.emergency` — the deadline scope of
  ``--preemption-save-deadline`` and the emergency saves.
"""
