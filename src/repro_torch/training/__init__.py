"""The training path (the port of ``repro.training``).

* :mod:`repro_torch.training.optimizer` — AdamW, clipping and the
  constant / cosine / WSD schedules, as plain tensor arithmetic;
* :mod:`repro_torch.training.data` — seeded synthetic and file-backed
  token streams with a restorable cursor (numpy, a copy);
* :mod:`repro_torch.training.checkpoint` — atomic, manifest-driven
  checkpoints in the JAX package's on-disk format;
* :mod:`repro_torch.training.trainer` — the eager train step and the
  fault-tolerant loop (accumulation, compression, straggler deadline,
  checkpoint/restart).
"""
