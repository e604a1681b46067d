"""The port of ``repro.distributed``; so far only ``compress`` (the
gradient compressors the trainer applies).  Sharding, the sharded
contraction, MoE all-to-all and pipeline stages are ROADMAP.md item 12."""
