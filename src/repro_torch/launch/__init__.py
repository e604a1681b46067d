"""Entry points (the port of ``repro.launch``; so far ``serve``)."""
