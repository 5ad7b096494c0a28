"""Host-side data pipelines (``pipeline.py``, numpy only)."""
