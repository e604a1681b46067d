"""The legacy fixed-slot serving engine (the port of ``repro.serving``)."""
