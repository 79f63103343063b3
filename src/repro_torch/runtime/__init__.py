"""The paged serving steps of the port (``runtime/executor.py``)."""
