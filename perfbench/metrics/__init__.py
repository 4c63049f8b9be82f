"""One reader per metric, named as the metric (``harness/readers.py``)."""
