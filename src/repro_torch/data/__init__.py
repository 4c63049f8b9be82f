"""Token sources and the training batch pipeline (``repro.data``)."""
